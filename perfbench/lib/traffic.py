"""Traffic of a cell, made from its mix file and the run's seed.

A mix file (``perfbench/traffic/<name>.json``) holds only parameters:

- ``loop``: ``"open"`` (requests due at Poisson arrival times, sent
  whether or not earlier ones finished) or ``"closed"`` (``clients``
  callers, each sending its next request when its last one returns);
- ``rate_per_s`` (open) or ``clients`` (closed, joining one by one over
  ``client_ramp_s``); ``lead_in_s``, the unmeasured lead before the
  window;
- ``resolutions`` and ``weights`` (the size mix), ``steps``;
- ``arrival_seed``: the arrival times of an open loop and the order of
  sizes are drawn from it;
- the program's knobs (``cache``, ``policy``, ``slo``, ``scheduler``) and
  the prewarm (``prewarm_compositions``).

``arrival_seed`` also fixes each request's size (a shuffle, block by
block of ``BLOCK`` requests, of the mix's proportions, so that any stretch
of the traffic holds the mix): every run meets the same schedule, like a
recorded trace.  The run seed draws each request's prompt and noise seed
(and the weights), which change the numbers and not the work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

BLOCK = 12  # requests a size block holds, each in the mix's proportions

# words of the prompts (the stand-in tokenizer hashes each word to an id)
WORDS = ("a photo of an astronaut riding horse on the moon city street at "
         "night with neon lights portrait old man oil painting mountain lake "
         "sunset forest river cat dog sitting chair red blue green golden "
         "hour cinematic wide angle close up detailed sharp focus soft light "
         "castle snow winter summer beach waves boat harbor market crowd "
         "robot garden flowers studio watercolor sketch ancient temple "
         "desert dunes storm clouds rain umbrella bicycle train station "
         "library books candle kitchen bread coffee cup window").split()


@dataclasses.dataclass
class Item:
    """One request of the traffic: due ``due_s`` after the traffic's
    start (open loop; a closed loop sends items in order)."""
    index: int
    resolution: int
    steps: int
    prompt: str
    seed: int
    due_s: float = 0.0


def poisson_arrivals_ms(qps: float, n: int, seed: int) -> np.ndarray:
    """Arrival times of ``n`` requests at ``qps``: the cumulative sum of
    exponential gaps, as ``sduss_tpu_torch/benchmark/traces.py``
    ``generate_trace`` draws them (copied there from the reference's trace
    generator; a later change may delete the program's copy)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1000.0 / qps, size=n))


def size_multiset(resolutions: Sequence[int], weights: Sequence[float],
                  n: int) -> List[int]:
    """``n`` sizes in the mix's proportions, largest remainders first."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    counts = np.floor(w * n).astype(int)
    for i in np.argsort(-(w * n - counts))[: n - counts.sum()]:
        counts[i] += 1
    return [r for r, c in zip(resolutions, counts) for _ in range(c)]


def _prompts(rng, n: int) -> List[str]:
    lens = rng.integers(6, 40, size=n)
    return [" ".join(rng.choice(WORDS, size=k)) for k in lens]


def items(mix: dict, seed: int, n: int) -> List[Item]:
    """The first ``n`` requests of the mix under ``seed``."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    order = np.random.default_rng([int(mix.get("arrival_seed", 0)), 5])
    block = size_multiset(mix["resolutions"], mix["weights"], BLOCK)
    sizes = [block[i] for _ in range(-(-n // BLOCK))
             for i in order.permutation(BLOCK)][:n]
    prompts = _prompts(rng, n)
    seeds = rng.integers(0, 2**31 - 1, size=n)
    due = (poisson_arrivals_ms(mix["rate_per_s"], n, mix["arrival_seed"])
           / 1000.0 if mix["loop"] == "open" else np.zeros(n))
    return [Item(i, int(sizes[i]), int(mix["steps"]), prompts[i],
                 int(seeds[i]), float(due[i])) for i in range(n)]


def horizon_items(mix: dict, seconds: float) -> int:
    """How many items a run may send: an open loop's arrivals over the
    lead-in, the window and a minute and a half of drain; a closed loop's
    clients, each at most one request a second of the same span."""
    span = float(mix["lead_in_s"]) + seconds + 90.0
    if mix["loop"] == "open":
        return int(np.ceil(mix["rate_per_s"] * span * 1.3)) + 20
    return int(mix["clients"]) * int(np.ceil(span)) + 1
