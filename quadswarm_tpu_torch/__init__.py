"""quadswarm_tpu_torch: the PyTorch/CUDA port of quadswarm_tpu.

The package mirrors quadswarm_tpu's layout module for module, so the
counterpart of `quadswarm_tpu/<path>` lives at `quadswarm_tpu_torch/<path>`.
It imports torch and numpy only.  Entry points run on the CUDA device unless
the caller passes `device="cpu"`; on CPU tensors every hand-written kernel
runs its plain PyTorch version, on CUDA tensors it launches the kernel.

Ported so far: the rollout path of the 8-drone mix run (policy forward plus
the batched env step, with the fused dynamics kernel in
`ops/kernels/dynamics_kernel.py` / `csrc/dynamics_kernel.cu`).
"""

__version__ = "0.1.0"
