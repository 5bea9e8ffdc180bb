"""The CoRL neighbour attention's first score layer and its activation at
rollout.swarm128's size (131,072 agents x 6 neighbours, hidden 256,
float32, TF32 off), without autograd, four ways: the concatenated form
tanh(W [e_i; mean e] + c); split by the weight's columns,
tanh(W_e e_i + (W_m mean e + c)), with the sum and tanh out of place (the
port's form) or in place; and split with the per-agent term broadcast into
the product's output (`addmm_`, beta 1).  Device ms a call from CUDA events
over 20 calls after warm-up, in two rounds, the peak memory of one call
above what it starts with, and the kernels of one call from the profiler.
On the card:

    python3 portbench/tools/score_layer.py
"""
import json

import torch
from torch.profiler import ProfilerActivity, profile

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
b, k, h = 131072, 6, 256
g = torch.Generator("cuda").manual_seed(0)
e = torch.tanh(torch.randn(b, k, h, device="cuda", generator=g))
w = torch.randn(h, 2 * h, device="cuda", generator=g) / 22.6
c = 0.1 * torch.randn(h, device="cuda", generator=g)
w_e, w_m = w.split(h, 1)


def cat_form():
    em = e.mean(1, keepdim=True).expand_as(e)
    return torch.tanh(torch.nn.functional.linear(torch.cat([e, em], -1), w, c))


def split_out_of_place():
    m = torch.nn.functional.linear(e.mean(1), w_m, c)
    return torch.tanh(torch.nn.functional.linear(e, w_e) + m[:, None])


def split_in_place():
    m = torch.nn.functional.linear(e.mean(1), w_m, c)
    z = torch.nn.functional.linear(e, w_e)
    return torch.tanh_(z.add_(m[:, None]))


def split_addmm():
    m = torch.nn.functional.linear(e.mean(1), w_m, c)
    z = m[:, None].expand(b, k, h).contiguous()
    z.view(b * k, h).addmm_(e.view(b * k, h), w_e.t())
    return torch.tanh_(z)


FORMS = {"cat": cat_form, "split_out_of_place": split_out_of_place,
         "split_in_place": split_in_place, "split_addmm": split_addmm}
out = {"card": torch.cuda.get_device_name(0)}
with torch.no_grad():
    ref = cat_form()
    for name, fn in list(FORMS.items()) * 2:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(20):
            y = fn()
        t1.record()
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        del y
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = fn()
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        del y
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = sorted(((ev.key[:70], round(ev.self_device_time_total, 1))
                       for ev in prof.key_averages()
                       if ev.self_device_time_total > 0),
                      key=lambda x: -x[1])
        out.setdefault(name, []).append(
            {"ms": t0.elapsed_time(t1) / 20, "max_err": err,
             "peak_mib": peak_mib, "kernels_us": kern})
        print(name, json.dumps(out[name][-1]), flush=True)
print(json.dumps(out))
