"""What surrounds the port's CUDA kernels in Python, on the CPU: K1's output
arenas and input checks, K3's launch shape.  The kernels themselves are
held to their plain versions on the card by tests/test_torch_kernels_cuda.py.
"""
from __future__ import annotations

import pytest
import torch

from quadswarm_tpu_torch.env.dynamics import init_state
from quadswarm_tpu_torch.ops.kernels import dynamics_kernel as dk
from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si


@pytest.mark.parametrize("b", [1, 1037, 8192])
def test_output_arenas_cut_into_aligned_disjoint_fields(b):
    layout = dk.arena_layout(b)
    arenas, views = dk.output_arenas(b, "cpu")
    arena_f, arena_b, arena_i = arenas
    assert [a.dtype for a in arenas] == [torch.float32, torch.bool,
                                         torch.int32]
    # 38 floats, 4 flags and one counter per drone; a float field starts on
    # a 16-byte boundary, so up to 3 floats of padding follow each when B
    # is no multiple of 4
    payload = sum(views[f].numel() for f in dk.ARENA_FLOAT_FIELDS)
    assert payload == 38 * b
    assert 38 * b <= arena_f.numel() == layout.float_numel <= 38 * b + 3 * 10
    if b % 4 == 0:
        assert arena_f.numel() == 38 * b
    assert arena_b.numel() == 4 * b and arena_i.numel() == b

    # every field is what the plain version returns for it
    want = init_state((b,), torch.float32, "cpu")
    assert set(views) == set(dk._OUT_FIELDS)
    for name, view in views.items():
        ref = getattr(want, name)
        assert view.shape == ref.shape and view.dtype == ref.dtype, name
        assert view.is_contiguous(), name

    # each view lies inside its arena, 16-byte aligned if float, and no two
    # views share a byte
    spans = []
    for name, view in views.items():
        arena = {torch.float32: arena_f, torch.bool: arena_b,
                 torch.int32: arena_i}[view.dtype]
        assert view.untyped_storage().data_ptr() \
            == arena.untyped_storage().data_ptr(), name
        start = view.data_ptr()
        stop = start + view.numel() * view.element_size()
        assert arena.data_ptr() <= start
        assert stop <= arena.data_ptr() + arena.numel() * arena.element_size()
        if view.dtype == torch.float32:
            assert (start - arena_f.data_ptr()) % 16 == 0, name
        spans.append((start, stop, name))
    spans.sort()
    for (_, stop, a), (start, _, c) in zip(spans, spans[1:]):
        assert stop <= start, (a, c)


def test_arena_layout_follows_the_kernels_field_order():
    # csrc/dynamics_kernel.cu: seven 3-vectors, rot, then the two (B, 4)
    # motor-filter fields, each span rounded up to 4 floats
    b = 6
    names = [f[0] for f in dk.arena_layout(b).float_fields]
    offsets = [f[1] for f in dk.arena_layout(b).float_fields]
    assert names == ["pos", "vel", "omega", "acc", "accelerometer",
                     "omega_dot", "torque", "rot", "thrust_cmds_damp",
                     "thrust_rot_damp"]
    span3, span9, span4 = 20, 56, 24          # 18, 54, 24 rounded up to 4
    assert offsets == [k * span3 for k in range(7)] + [
        7 * span3, 7 * span3 + span9, 7 * span3 + span9 + span4]
    assert dk.arena_layout(b).float_numel == 7 * span3 + span9 + 2 * span4


def test_output_arena_writes_do_not_leak_between_fields():
    _, views = dk.output_arenas(5, "cpu")
    for k, view in enumerate(views.values()):
        view.fill_(k % 2 if view.dtype == torch.bool else k)
    for k, (name, view) in enumerate(views.items()):
        want = k % 2 if view.dtype == torch.bool else k
        assert bool((view == want).all()), name


def _inputs(b: int, device="cpu") -> list:
    state = init_state((b,), torch.float32, device)
    return list(dk.kernel_inputs(
        state, torch.zeros((b, 4), device=device),
        torch.zeros((b, 4), device=device), torch.zeros((b,), device=device)))


def test_input_checks_pass_what_the_kernel_takes():
    dk.check_inputs(tuple(_inputs(7)), 7, torch.device("cpu"))


@pytest.mark.parametrize("fault,error,match", [
    ("device", ValueError, "is on meta"),
    ("dtype", TypeError, "has dtype torch.float64"),
    ("shape", ValueError, "has shape"),
    ("contiguity", ValueError, "not contiguous"),
])
@pytest.mark.parametrize("which", [0, 2, 8, 10])
def test_input_checks_raise_on_each_fault_of_each_kind_of_input(
        which, fault, error, match):
    """pos, rot, thrust_cmds and rand_yaw_theta, each on a wrong device, of a
    wrong dtype, of a wrong shape, and non-contiguous."""
    b = 6
    inputs = _inputs(b)
    t = inputs[which]
    if fault == "device":
        t = torch.empty(t.shape, dtype=t.dtype, device="meta")
    elif fault == "dtype":
        t = t.double()
    elif fault == "shape":
        t = torch.zeros((b + 1,) + t.shape[1:], dtype=t.dtype)
    else:
        t = torch.zeros((2 * b,) + t.shape[1:], dtype=t.dtype)[::2]
        assert not t.is_contiguous()
    inputs[which] = t
    with pytest.raises(error, match=match):
        dk.check_inputs(tuple(inputs), b, torch.device("cpu"))
    assert dk._IN_NAMES[which] in ("pos", "rot", "thrust_cmds",
                                   "rand_yaw_theta")


@pytest.mark.parametrize("which", [4, 5, 8, 9])
def test_input_checks_refuse_a_four_wide_input_off_a_16_byte_boundary(which):
    """thrust_cmds_damp, thrust_rot_damp, thrust_cmds and ou_state are read
    as one 16-byte word per drone; a row slice of an aligned tensor passes."""
    b = 6
    inputs = _inputs(b)
    inputs[which] = torch.zeros((b + 1, 4))[1:]
    dk.check_inputs(tuple(inputs), b, torch.device("cpu"))
    odd = torch.zeros(4 * b + 1)[1:].view(b, 4)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    inputs[which] = odd
    with pytest.raises(ValueError, match="16-byte boundary"):
        dk.check_inputs(tuple(inputs), b, torch.device("cpu"))
    assert dk._IN_TRAILING[which] == (4,)


@pytest.mark.parametrize("n,per_lane,rows", [
    (2, 4, 8), (9, 4, 8), (33, 4, 8), (128, 4, 8), (129, 8, 16),
    (256, 8, 16), (257, 0, 16), (2048, 0, 16)])
def test_topk_launch_shape(n, per_lane, rows):
    assert si.topk_launch_shape(n) == (per_lane, rows)
    if per_lane:
        assert n <= 32 * per_lane             # every column has a register
    # six planes of n floats and, on the shared-memory route, a padded row
    # of keys per warp fit what a block of an H100 can opt into (227 KB)
    keys = 0 if per_lane else rows * 32 * -(-n // 32)
    assert 4 * (6 * n + keys) <= 232448
    assert 32 * rows <= 1024
