"""A full step: every part of the UNet, for the request's CFG pair; also
the step of a cache-off path (mode None)."""


def work(table: dict, gated: dict, fresh: bool):
    """``(operations, attention calls [(ops, bytes)])``."""
    calls = [c for part in table["attn"].values() for c in part]
    return table["full"], calls
