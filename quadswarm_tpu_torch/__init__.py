"""quadswarm_tpu_torch: the PyTorch/CUDA port of quadswarm_tpu.

The package mirrors quadswarm_tpu's layout module for module, so the
counterpart of `quadswarm_tpu/<path>` lives at `quadswarm_tpu_torch/<path>`.
It imports torch and numpy only.  Entry points run on the CUDA device unless
the caller passes `device="cpu"`; on CPU tensors every hand-written kernel
runs its plain PyTorch version, on CUDA tensors it launches the kernel.

Every module of quadswarm_tpu has its counterpart; the Pallas kernels'
counterparts are hand-written CUDA kernels (`csrc/*.cu`, bound in
`ops/kernels/`): the fused dynamics kernel, which every env tick launches,
and the pair kernels of the large-swarm env route.
"""

__version__ = "0.1.0"
