"""The generator: the same seed gives the same traffic; every seed meets
the same arrivals and the same multiset of sizes."""

import json
from collections import Counter

from perfbench.lib import spec, traffic


def mix(name="sdxl-mix-open"):
    with open(spec.BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def test_same_seed_same_items():
    a = traffic.items(mix(), 2**31 + 5, 200)
    b = traffic.items(mix(), 2**31 + 5, 200)
    assert a == b


def test_seeds_share_the_schedule_not_the_content():
    a = traffic.items(mix(), 1, 300)
    b = traffic.items(mix(), 987654321987, 300)
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert [x.resolution for x in a] == [x.resolution for x in b]
    assert [x.prompt for x in a] != [x.prompt for x in b]
    assert [x.seed for x in a] != [x.seed for x in b]


def test_arrival_rate_and_mix():
    m = mix()
    its = traffic.items(m, 3, 3000)
    rate = len(its) / its[-1].due_s
    assert abs(rate - m["rate_per_s"]) / m["rate_per_s"] < 0.1
    counts = Counter(x.resolution for x in its)
    assert max(counts.values()) - min(counts.values()) <= 1


def test_closed_loop_items_have_no_due_times():
    its = traffic.items(mix("sd15-512-closed"), 4, 50)
    assert all(x.due_s == 0.0 and x.resolution == 512 for x in its)
    assert traffic.horizon_items(mix("sd15-512-closed"), 51) >= 40 * 151


def test_poisson_copy_matches_program_generator():
    import numpy as np

    from sduss_tpu_torch.benchmark.traces import generate_trace

    rows = generate_trace(2.0, 50, (512, 768, 1024), seed=9)
    ours = traffic.poisson_arrivals_ms(2.0, 50, 9)
    assert np.allclose([r.arrival_ms for r in rows], ours)


def test_every_block_holds_the_mix():
    its = traffic.items(mix(), 42, 120)
    for b in range(0, 120, traffic.BLOCK):
        sizes = Counter(x.resolution for x in its[b:b + traffic.BLOCK])
        assert sizes == Counter({512: 4, 768: 4, 1024: 4})
