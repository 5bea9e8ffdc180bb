"""The device-to-host sync counter: a frozen copy of `chip_smoke.py`'s
`SyncCounter`, which counts the implicit synchronisations of the CUDA calls
made inside it (`torch.cuda.set_sync_debug_mode`) apart from explicit
`torch.cuda.synchronize()` calls.  Off the card it counts nothing."""
from __future__ import annotations

import os
import warnings

import torch


class SyncCounter:
    def __init__(self, device="cuda"):
        self.on = torch.device(device).type == "cuda"
        self.implicit = self.explicit = 0

    def __enter__(self):
        if not self.on:
            return self
        self._catch = warnings.catch_warnings(record=True)
        self.records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        syncs = [r for r in self.records
                 if "synchronizing" in str(r.message)]
        explicit = os.path.join("torch", "cuda", "__init__.py")
        self.explicit = sum(r.filename.endswith(explicit) for r in syncs)
        self.implicit = len(syncs) - self.explicit
        return False
