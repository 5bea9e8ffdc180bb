"""Rows the stacked heads computed for each agent row they served, over the
traced call: the program's counters `pbt.head_rows` / `pbt.agent_rows`
(host integers, `utils/tracing.py::count`).  Every head on every row reads
the number of policies; each row under its own head alone reads 1."""
from portbench import program_counts


def read(rec):
    rows = program_counts.load(rec)
    if not rows or not rows.get("pbt.agent_rows"):
        return None
    return rows.get("pbt.head_rows", 0) / rows["pbt.agent_rows"]
