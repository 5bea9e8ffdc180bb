"""Running mean-std input/return normalization.

Port of quadswarm_tpu/parallel/normalize.py (Sample Factory's
`--normalize_input` / `--normalize_returns`):

- `normalize_input`: observations are standardized with running per-feature
  mean/var and clipped to +-5 before the encoder, in rollout inference and
  in the learner's recompute.  The stats fold in each iteration's rollout
  observations once, before the SGD phase.
- `normalize_returns`: the critic learns in normalized return space.  Value
  predictions are denormalized (v * std + mean) where they act as
  bootstraps in reward space (GAE); the value loss compares the raw
  prediction with normalized returns, its clip anchor moved into the same
  space.  The stats fold in each iteration's GAE returns before SGD.

The update is Chan et al.'s parallel-variance combine, with population
statistics (`correction=0`, as `jnp.var`), so sequential batch updates equal
the stats of the concatenated data.  On a mesh of ranks a batch is every
rank's rows together: the global count, mean and centred sum of squares
come from all-reduced sums, as the JAX package's statistics over a sharded
batch are global.  A state is an immutable value: every
update returns a new one.
"""
from __future__ import annotations

import dataclasses

import torch

from quadswarm_tpu_torch.parallel.mesh import all_sum, world_size
from quadswarm_tpu_torch.utils.struct import Struct, map_fields


@dataclasses.dataclass
class RunningMeanStd(Struct):
    mean: torch.Tensor   # (dim,) or scalar ()
    var: torch.Tensor
    count: torch.Tensor  # scalar ()

    @classmethod
    def create(cls, dim: int | None = None, dtype=torch.float32,
               device="cpu"):
        shape = () if dim is None else (dim,)
        return cls(mean=torch.zeros(shape, dtype=dtype, device=device),
                   var=torch.ones(shape, dtype=dtype, device=device),
                   count=torch.tensor(1e-4, dtype=dtype, device=device))

    def _combine(self, batch_mean, batch_var, batch_count):
        delta = batch_mean - self.mean
        total = self.count + batch_count
        new_mean = self.mean + delta * batch_count / total
        m2 = (self.var * self.count + batch_var * batch_count
              + delta ** 2 * self.count * batch_count / total)
        return self.replace(mean=new_mean, var=m2 / total, count=total)

    def update(self, x: torch.Tensor, mesh=None) -> "RunningMeanStd":
        """Fold a batch (leading axes arbitrary, trailing axes match mean)
        into the running stats: its mean, then the mean square about it
        (two passes, as `jnp.var`).  With a `mesh` of ranks the batch is
        every rank's `x` together: the sums are all-reduced."""
        x = x.to(self.mean.dtype)
        dims = tuple(range(x.dim() - self.mean.dim()))
        batch_count = (x.numel() // max(self.mean.numel(), 1)
                       * world_size(mesh))
        batch_mean = all_sum(mesh, torch.sum(x, dim=dims)) / batch_count
        batch_var = all_sum(mesh, torch.sum((x - batch_mean) ** 2,
                                            dim=dims)) / batch_count
        return self._combine(batch_mean, batch_var, batch_count)

    def update_masked(self, x: torch.Tensor, w: torch.Tensor,
                      mesh=None) -> "RunningMeanStd":
        """Fold only the rows of `x` with weight 1 in `w` into the stats.

        `x` is (B,) + mean.shape, `w` is (B,) in {0, 1}.  Equals `update()`
        restricted to the selected rows; with no selected row the stats are
        unchanged.  With a `mesh`, the rows of every rank: the count and
        sum in one all-reduce, the sum of squares in a second."""
        x = x.to(self.mean.dtype)
        w = w.to(self.mean.dtype)
        wb = w.reshape(w.shape + (1,) * self.mean.dim())
        size = self.mean.numel()
        first = all_sum(mesh, torch.cat([torch.sum(wb * x, 0).reshape(-1),
                                         torch.sum(w).reshape(1)]))
        batch_count = first[size]
        denom = torch.clamp(batch_count, min=1.0)
        batch_mean = (first[:size] / denom).reshape(self.mean.shape)
        batch_var = all_sum(mesh, torch.sum(wb * (x - batch_mean) ** 2,
                                            0)) / denom
        new = self._combine(batch_mean, batch_var, batch_count)
        empty = batch_count == 0
        return map_fields(lambda a, b: torch.where(empty, a, b), self, new)

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var + 1e-8)

    def normalize(self, x: torch.Tensor, clip: float | None = 5.0):
        y = (x - self.mean) / self.std()
        if clip is not None:
            y = torch.clamp(y, -clip, clip)
        return y.to(x.dtype)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return (y * self.std() + self.mean).to(y.dtype)


@dataclasses.dataclass
class NormalizerState(Struct):
    """Optional obs/return normalizers; a None field is a feature that is
    off."""
    obs: RunningMeanStd | None = None
    ret: RunningMeanStd | None = None


def make_norm_state(normalize_input: bool, normalize_returns: bool,
                    obs_dim: int, device="cpu") -> NormalizerState:
    return NormalizerState(
        obs=(RunningMeanStd.create(obs_dim, device=device)
             if normalize_input else None),
        ret=RunningMeanStd.create(device=device) if normalize_returns
        else None)


def normalize_obs(norm: NormalizerState | None, obs_flat: torch.Tensor):
    if norm is not None and norm.obs is not None:
        return norm.obs.normalize(obs_flat)
    return obs_flat


def denormalize_value(norm: NormalizerState | None, value: torch.Tensor):
    if norm is not None and norm.ret is not None:
        return norm.ret.denormalize(value)
    return value
