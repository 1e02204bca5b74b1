"""A partial step (the dense path's row warmup): the shallow spine for
every row, and the deep tail for the rows that need a fresh feature
(``fresh``)."""

from perfbench.work import shallow


def work(table: dict, gated: dict, fresh: bool):
    ops, calls = shallow.work(table, gated, fresh)
    if fresh:
        ops += table["tail"]
        calls = calls + table["attn"].get("tail", [])
    return ops, calls
