"""A shallow step of the deep cache: the fixed parts, the deep feature
reused, and of the gated pairs only the share recomputed for this request
(``gated[key]``: 1 both CFG halves, 0.5 one, 0 none); a reused half needs
no work."""


def work(table: dict, gated: dict, fresh: bool):
    share = {k: float(gated.get(k, 1.0)) for k in table["pairs"]}
    calls = list(table["attn"].get("fixed", []))
    for k, f in share.items():
        calls += [(fl * f, nb * f) for fl, nb in table["attn"].get(k, [])]
    return (table["fixed"] + sum(table["pairs"][k] * f
                                 for k, f in share.items()), calls)
