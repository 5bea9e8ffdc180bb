"""Implicit device-to-host syncs a tick over the traced call
(`counters.SyncCounter`)."""


def read(rec):
    if rec.trace is None or not rec.trace.get("ticks"):
        return None
    return rec.trace["syncs"] / rec.trace["ticks"]
