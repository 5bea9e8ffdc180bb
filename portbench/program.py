"""The system under test, built as its training CLI builds it: the
configuration's flags through `training/config.py`'s functions.  Also the
pieces every driver shares: the benchmark's weights, the control's
precision, the record of each tick's state, and the flags as the
reference reads them."""
from __future__ import annotations

import torch

from portbench.harness import make_weights
from portbench.reference.convert import tree_map

# The control, in the precision below the configuration's: TF32 products
# for the float32 model (on the CPU, which has no TF32, a bfloat16 model)
# and a bfloat16 env state for the float32 env, both the program's own
# paths.
CONTROL_FLAGS = {"cuda": ["--dtype=bfloat16"],
                 "cpu": ["--dtype=bfloat16", "--model_dtype=bfloat16"]}


def reference_flags(cell, overrides) -> dict:
    """The flags as the reference reads them: the configuration's, with the
    test's small sizes, never the control's precision."""
    from quadswarm_tpu_torch.training.config import parse_swarm_cfg
    return vars(parse_swarm_cfg(cell.flags() + list(overrides or [])))


def program_args(cell, overrides, device, control: bool):
    from quadswarm_tpu_torch.training.config import parse_swarm_cfg
    extra = CONTROL_FLAGS[torch.device(device).type] if control else []
    return parse_swarm_cfg(cell.flags() + list(overrides or []) + extra
                           + [f"--device={device}"])


def control_products(control: bool, device) -> None:
    """After the program's models are built (their constructor turns TF32
    off), the control's products go to TF32."""
    if control and torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True


def full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Built:
    """The env, dynamics, PPO settings and reward coefficients of a run."""

    def __init__(self, args, device):
        from quadswarm_tpu_torch.env.params import make_dynamics_params
        from quadswarm_tpu_torch.env.reward import RewardCoeffs
        from quadswarm_tpu_torch.training.config import (
            base_rew_coeff_from_args, env_config_from_args,
            ppo_config_from_args,
        )
        self.args = args
        self.device = torch.device(device)
        self.env_cfg = env_config_from_args(args)
        self.dyn = make_dynamics_params(dt=self.env_cfg.dt)
        self.ppo = ppo_config_from_args(args)
        self.rew_coeff = RewardCoeffs(**base_rew_coeff_from_args(args))

    def new_model(self):
        from quadswarm_tpu_torch.training.config import model_from_args
        return model_from_args(self.args, self.env_cfg, device=self.device)

    def weights(self, seed: int) -> dict:
        """The benchmark's weights, made on the device."""
        template = self.new_model()
        shapes = {k: tuple(v.shape) for k, v in template.state_dict().items()}
        del template
        return make_weights(shapes, self.args.initial_stddev, seed,
                            self.device)


class StepRecorder:
    """While entered, watches the rollouts' env step (the names
    `batched_replay_step` and `batched_env_step`) and action draw
    (`sample_actions`) in `parallel/ppo.py`:
    each tick's env state, as the env step is given it, is copied
    (`states`), and the generator's state is kept before the actions are
    drawn (`sample_gens`) and before the env step (`env_gens`)."""

    # (name, position of the env state, position of the generator)
    STEPS = (("batched_replay_step", 3, 6), ("batched_env_step", 2, 4))

    def __init__(self):
        self.states, self.env_gens, self.sample_gens = [], [], []

    def __enter__(self):
        import quadswarm_tpu_torch.parallel.ppo as ppo
        self.saved = []
        for name, at_state, at_gen in self.STEPS:
            self._patch(ppo, name, self._step(getattr(ppo, name), at_state,
                                              at_gen))
        self._patch(ppo, "sample_actions", self._sample(ppo.sample_actions))
        return self

    def _patch(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def _step(self, fn, at_state, at_gen):
        def recorded(*a, **kw):
            self.states.append(tree_clone(a[at_state]))
            self.env_gens.append(a[at_gen].get_state())
            return fn(*a, **kw)
        return recorded

    def _sample(self, fn):
        def recorded(gen, *a, **kw):
            self.sample_gens.append(gen.get_state())
            return fn(gen, *a, **kw)
        return recorded

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        return False


def tree_clone(obj):
    """A copy of a tree of the program's state, every tensor cloned."""
    return tree_map(lambda t: t.detach().clone(), obj)


def finite(*tensors) -> bool:
    """Whether every output of a call is finite (one device read)."""
    flags = [torch.isfinite(t.float()).all() for t in tensors]
    return bool(torch.stack(flags).all())
