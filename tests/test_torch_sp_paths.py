"""Every path and cache over an sp group, on the CPU, against the port's
one device and the JAX package's GSPMD engines.

A replica over ``sp`` shards serves each forward through the denoiser's
sharded route (``parallel/sharding.py``): the dense latents' rows, the
patch batch's rows or SD3's token columns split over the shards.  The
gates select over the whole batch, so each sharded run picks the same
modes, rows, images and tokens as one device (recorded from every
``BlockCache`` gate a shard runs) and its latents stay within
RTOL 2e-4 / ATOL 5e-4 of one device's:

- (a) dense gated caches of the tiny SD-1.5, mixed batches off: both
  ``production("sd15")`` presets (the row-warmup hybrid with an admission
  mid-flight, and adaptive + predict), modes "compact" and "block", at
  sp=2 and sp=2 x tp=2; the serving preset also against JAX's sp=2
  engine on the same weights.  Under ``sp_mode="displaced"`` the hybrid
  runs sync and ``_disp_state`` stays empty.
- (b) the patch batch (the default config, 64^2 + 128^2 at 64 px
  patches) at sp=2 x tp=2: cache-off against JAX's sp=2 x tp=2 engine
  (the port's ``test_engine_submesh_replicas`` with mixed batches on);
  ``production("sd15")``, "block" and two-level "compact" against one
  device (held against JAX's in ``test_torch_mixed_deep_slice.py`` and
  ``test_torch_block_cache_slice.py``), and "block" at sp=2 against JAX's
  sp=2 pipeline.
- (c) the tiny SD3 on its padded-token path at sp=2, 64^2 + 128^2:
  cache-off and the span cache (1, 2) against JAX's sp=2 engines;
  "block" and the fine token gate at ``patch_fraction`` 0.5 with
  ``fine_stale_kv`` against one device.
- The rows, the span delta and the fine gate's state stay on their shard
  between steps: over two steps of a stable composition each shard's
  parts keep their storage, and the per-shard bytes count them.  The
  patch batch's rows follow a composition that changes.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.config import ParallelConfig as JaxParallelConfig
from sduss_tpu.engine.engine import Engine as JaxEngine
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.ops import patching
from sduss_tpu_torch.ops.patch_ctx import PatchContext
from sduss_tpu_torch.parallel.sharding import ShardedTensor
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_dp import ATOL, RTOL
from test_torch_slice import _np_init, torch_threads  # noqa: F401
from test_torch_sp import bundle  # noqa: F401

PATCH = 64
SD3_RES = (64, 128)
# what each gate's stats say it selected
PICKS = {"gate": ("fresh",), "gate_compact": ("idx",),
         "gate_compact_pairs": ("idx",),
         "gate_compact_images": ("images", "gather", "tok_sel"),
         "gate_tokens_fine": ("sel",)}


@pytest.fixture
def picks(monkeypatch):
    """Every gate call's selections, by the rank of the thread that ran
    it (0 off the shard threads): ``{rank: [(gate, key, {stat: array})]}``."""
    calls = collections.defaultdict(list)
    for name, stats in PICKS.items():
        real = getattr(BlockCache, name)

        def spy(self, key, *a, _real=real, _name=name, _stats=stats, **kw):
            out = _real(self, key, *a, **kw)
            thread = threading.current_thread().name
            rank = (int(thread.split("-")[1].split("_")[0])
                    if thread.startswith("shard-") else 0)
            calls[rank].append((_name, key, {
                k: out[2][k].cpu().numpy().copy() for k in _stats
                if out[2] and k in out[2]}))
            return out

        monkeypatch.setattr(BlockCache, name, spy)
    return calls


def assert_same_picks(calls, one: list, sp: int, tp: int, rows_split=None):
    """Each sp shard (tp index 0) ran the one device's gate calls and
    picked what it picked; with ``rows_split`` (the patch batch's real
    rows, a bool mask) the block gate's per-row decisions are the shards'
    rows in order."""
    lead = [calls[i * tp] for i in range(sp)]
    assert all(len(c) == len(one) for c in lead), [len(c) for c in lead]
    assert one, "no gate ran"
    for k, (name, key, stats) in enumerate(one):
        got = [c[k] for c in lead]
        assert all(g[:2] == (name, key) for g in got), (k, name, key)
        for stat, want in stats.items():
            if rows_split is not None and name == "gate":
                # the shards' rows in order; the pad patches' decisions
                # read garbage (the dummy image's unit-variance noise)
                have = np.concatenate([g[2][stat] for g in got])[rows_split]
                want = want[rows_split]
            else:
                have = got[0][2][stat]
                for g in got[1:]:
                    np.testing.assert_array_equal(g[2][stat], have)
            np.testing.assert_array_equal(have, want, err_msg=f"{k} {name} "
                                          f"{key} {stat}")


def _config(family, sp=1, tp=1, mixed=False, cache=None, mode="gspmd"):
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = mixed
    config.scheduler.patch_size = PATCH
    if family == "sd3":
        config.model.resolutions = SD3_RES
    config.cache = cache if cache is not None else CacheConfig()
    config.parallel.sp, config.parallel.tp = sp, tp
    config.parallel.sp_mode, config.parallel.displaced_warmup = mode, 1
    return config


def _pipe(bundle, family, sp=1, tp=1, **kw):
    return build_pipeline(_config(family, sp, tp, **kw), ["cpu"] * (sp * tp),
                          bundle=bundle)


def _requests(plan, steps) -> list:
    return [Request(rid, SamplingParams(
        prompt=f"a prompt for {rid}", negative_prompt="blurry",
        resolution=res, num_inference_steps=steps, seed=seed,
        output_type="latent")) for rid, res, seed, _ in plan]


def _drive(pipe, plan, steps, mixed, evict=False):
    """``plan``: ``[(id, resolution, seed, first step)]``; each request
    joins the batch at its first step (with ``evict``, the pipeline drops
    a request's state once it finishes, as the engine does).  Returns the
    final latents."""
    reqs = _requests(plan, steps)
    pipe.prepare(reqs)
    pipe.step_modes = []
    for step in range(steps + max(p[3] for p in plan)):
        live = [r for r, p in zip(reqs, plan)
                if p[3] <= step and r.remain_steps > 0]
        if not live:
            break
        by_res = {}
        for r in live:
            by_res.setdefault(r.resolution, []).append(r)
        (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(by_res)
        if evict:
            pipe.evict_finished_state([r.request_id for r in live
                                       if r.remain_steps == 0])
    return {r.request_id: np.asarray(r.latents[0], np.float32)
            for r in reqs}


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for rid, w in want.items():
        assert np.isfinite(got[rid]).all()
        np.testing.assert_allclose(got[rid], w, rtol=RTOL, atol=ATOL,
                                   err_msg=rid)


def _jax_engine(family, sp=1, tp=1, mixed=False, cache=None):
    config = JaxConfig()
    extra = {"resolutions": SD3_RES} if family == "sd3" else {}
    config.model = JaxModelConfig(model=family, dtype="float32",
                                  test_tiny=True, use_patched=mixed, seed=3,
                                  **extra)
    config.parallel = JaxParallelConfig(sp=sp, tp=tp)
    config.scheduler.use_mixed_resolution = mixed
    config.scheduler.patch_size = PATCH
    if cache is not None:
        config.cache = JaxCacheConfig(**dataclasses.asdict(cache))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        return JaxEngine(config)


def _serve(engine, params_cls, plan, steps):
    for rid, res, seed, _ in plan:
        engine.add_request(rid, params_cls(
            prompt=f"a prompt for {rid}", negative_prompt="blurry",
            resolution=res, num_inference_steps=steps, seed=seed,
            output_type="latent"))
    outs = {}
    while engine.has_unfinished_requests():
        for o in engine.step():
            outs[o.request_id] = np.asarray(o.image, np.float32)
    return outs


def _jax_drive(jengine, plan, steps, mixed=True):
    """The JAX engine's pipeline driven step by step, as :func:`_drive`
    drives the port's (the engine's worker would serve a cold mixed
    composition dense while a daemon compiles it, on its own clock)."""
    from sduss_tpu.request import Request as JaxRequest

    jpipe = jengine.workers[0].pipeline
    reqs = [JaxRequest(rid, JaxSamplingParams(
        prompt=f"a prompt for {rid}", negative_prompt="blurry",
        resolution=res, num_inference_steps=steps, seed=seed,
        output_type="latent")) for rid, res, seed, _ in plan]
    jpipe.prepare(reqs)
    for _ in range(steps):
        by_res = {}
        for r in reqs:
            by_res.setdefault(r.resolution, []).append(r)
        (jpipe.denoise_step_mixed if mixed else jpipe.denoise_step)(by_res)
    return {r.request_id: np.asarray(r.latents[0], np.float32)
            for r in reqs}


def _port_bundle(jengine, family):
    params = jengine.workers[0].pipeline.bundle.params
    out = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
    out.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    return out


# -- (a) dense gated caches -------------------------------------------------

DENSE = [("d0", 64, 1, 0), ("d1", 64, 2, 2)]  # d1 joins at step 2
DENSE_CACHES = {
    "serving": CacheConfig.production("sd15"),
    "offline": CacheConfig.production("sd15", serving=False),
    "compact": CacheConfig(enabled=True, mode="compact",
                           compact_fraction=0.5, max_hits=2),
    "block": CacheConfig(enabled=True, mse_threshold=0.05, max_hits=2),
}


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=["sp2", "sp2tp2"])
@pytest.mark.parametrize("case", sorted(DENSE_CACHES))
def test_dense_gated_caches_follow_one_device(bundle, picks, case, layout):
    """Each dense cache over the group: the same deep modes and gate
    selections as one device, latents within tolerance; an admission
    mid-flight carries the hybrid's rows over on every shard."""
    cache = DENSE_CACHES[case]
    ref = _pipe(bundle, "sd15", cache=cache)
    one = _drive(ref, DENSE, 6, False)
    one_picks, one_modes = list(picks[0]), ref.step_modes
    picks.clear()
    sp, tp = layout
    pipe = _pipe(bundle, "sd15", sp, tp, cache=cache)
    got = _drive(pipe, DENSE, 6, False)
    _close(got, one)
    assert pipe.step_modes == one_modes
    if case == "block":  # mode "block" gates only mixed batches: the sp step
        assert not one_picks and pipe.displaced_steps["sync"] > 0
        return
    assert_same_picks(picks, one_picks, sp, tp)
    if case == "serving":
        assert set(one_modes) == {"full", "partial", "shallow"}
    assert not pipe._disp_state and pipe.displaced_steps["sync"] == 0


def test_dense_serving_preset_against_jax_sp2(bundle):
    """``production("sd15")`` over sp=2 against JAX's sp=2 engine (GSPMD)
    on the same weights and requests."""
    cache = CacheConfig.production("sd15")
    plan = [("j0", 64, 7, 0), ("j1", 64, 8, 0)]
    want = _serve(_jax_engine("sd15", 2, cache=cache), JaxSamplingParams,
                  plan, 4)
    engine = Engine(_config("sd15", 2, cache=cache), "cpu", bundle=bundle)
    _close(_serve(engine, SamplingParams, plan, 4), want)


def test_displaced_gated_cache_runs_sync(bundle):
    """Under ``sp_mode="displaced"`` the hybrid takes precedence: its
    steps run sync on the sharded route and ``_disp_state`` stays empty
    (JAX's ``test_displaced_gated_cache_precedence_falls_back``)."""
    cache = CacheConfig.production("sd15")
    pipe = _pipe(bundle, "sd15", 2, cache=cache, mode="displaced")
    got = _drive(pipe, DENSE, 4, False)
    one = _drive(_pipe(bundle, "sd15", cache=cache), DENSE, 4, False)
    _close(got, one)
    assert not pipe._disp_state
    assert pipe.displaced_steps == {"sync": 0, "stale": 0}


# -- (b) the patch batch ------------------------------------------------------

MIXED = [("m0", 64, 3, 0), ("m1", 128, 4, 0)]
MIXED_CACHES = {
    "production": CacheConfig.production("sd15", serving=False),
    "block": CacheConfig(enabled=True, mse_threshold=0.05, max_hits=2),
    "compact-two-level": CacheConfig(enabled=True, mode="compact",
                                     compact_fraction=0.5,
                                     patch_fraction=0.5, max_hits=3),
}


@pytest.fixture(scope="module")
def jax_mixed():
    """JAX's sp=2 engine on the patch path, its pipeline driven cache-off
    (2 steps), then in mode "block" (4 steps): the latents of each, and
    the port's bundle of its weights."""
    engine = _jax_engine("sd15", 2, mixed=True)
    outs = {"off": _jax_drive(engine, MIXED, 2)}
    jpipe = engine.workers[0].pipeline
    jpipe.config.cache = JaxCacheConfig(**dataclasses.asdict(
        MIXED_CACHES["block"]))
    jpipe.release_serving_state()
    outs["block"] = _jax_drive(engine, MIXED, 4)
    return _port_bundle(engine, "sd15"), outs


def test_patch_batch_against_jax_submesh(jax_mixed):
    """The default config's counterpart of JAX's
    ``test_engine_submesh_replicas``: sp=2 x tp=2 with mixed batches on, a
    64^2 + 128^2 batch on the patch path, against JAX's sp=2 pipeline
    (its sp=2 x tp=2 one departs from its own one device on the patch
    path, ROADMAP "Known differences") and the port's one device."""
    bundle15, want = jax_mixed
    engine = Engine(_config("sd15", 2, 2, mixed=True), "cpu",
                    bundle=bundle15)
    pipe = engine.workers[0].pipeline
    assert (pipe.group.sp, pipe.group.tp) == (2, 2)
    steps = []
    mixed = pipe.denoise_step_mixed
    pipe.denoise_step_mixed = lambda by_res: (steps.append(len(by_res)),
                                              mixed(by_res))[1]
    got = _serve(engine, SamplingParams, MIXED, 2)
    assert steps == [2, 2]  # both steps ran the patch batch
    _close(got, want["off"])
    one = Engine(_config("sd15", mixed=True), "cpu", bundle=bundle15)
    _close(got, _serve(one, SamplingParams, MIXED, 2))


def test_patch_block_against_jax_sp2(jax_mixed):
    """Mode "block" on the patch batch over sp=2 against JAX's sp=2
    pipeline on the same weights and requests."""
    bundle15, want = jax_mixed
    pipe = _pipe(bundle15, "sd15", 2, cache=MIXED_CACHES["block"],
                 mixed=True)
    _close(_drive(pipe, MIXED, 4, True), want["block"])


@pytest.mark.parametrize("case", sorted(MIXED_CACHES))
def test_patch_batch_caches_follow_one_device(bundle, picks, case):
    """Each cache on the patch batch over sp=2 x tp=2: the same modes,
    images, patch rows and per-row decisions as one device, latents within
    tolerance."""
    cache = MIXED_CACHES[case]
    ref = _pipe(bundle, "sd15", cache=cache, mixed=True)
    one = _drive(ref, MIXED, 5, True)
    one_picks = list(picks[0])
    picks.clear()
    pipe = _pipe(bundle, "sd15", 2, 2, cache=cache, mixed=True)
    got = _drive(pipe, MIXED, 5, True)
    _close(got, one)
    assert pipe.step_modes == ref.step_modes
    sc = ref.config.scheduler
    real = PatchContext(patching.double_meta(
        (1, 2), PATCH // 8, tuple(sc.patch_buckets),
        tuple(sc.batch_buckets)), "cpu").patch_valid.numpy()
    assert_same_picks(picks, one_picks, 2, 2, rows_split=real)
    if case == "production":
        assert set(ref.step_modes) == {"full", "shallow"}


def test_patch_rows_follow_membership_under_sp(bundle, picks):
    """The patch batch's two-level compact rows over sp=2 while the
    composition changes: a request joins at step 2 (its batch's rows go
    back to their requests, then into the new batch's), two finish at
    step 4 and the third goes on alone; the same picks as one device,
    latents within tolerance, and no batch of rows left at the end."""
    cache = MIXED_CACHES["compact-two-level"]
    plan = MIXED + [("m2", 64, 5, 2)]
    one = _drive(_pipe(bundle, "sd15", cache=cache, mixed=True), plan, 4,
                 True, evict=True)
    one_picks = list(picks[0])
    picks.clear()
    pipe = _pipe(bundle, "sd15", 2, cache=cache, mixed=True)
    _close(_drive(pipe, plan, 4, True, evict=True), one)
    assert_same_picks(picks, one_picks, 2, 1)
    assert not pipe._batch_rows


# -- (c) SD3's padded-token path ---------------------------------------------

SD3_PLAN = [("s0", 64, 5, 0), ("s1", 128, 6, 0)]
SPAN = dataclasses.replace(CacheConfig.production("sd3", serving=False),
                           sd3_deep_span=(1, 2), deep_interval=3,
                           deep_warmup=1)


@pytest.fixture(scope="module")
def sd3_jax():
    """JAX's sp=2 SD3 engines (cache-off, then the span cache) and their
    latents on the same requests, with the port's bundle of their
    weights."""
    off = _jax_engine("sd3", 2, mixed=True)
    outs = {"off": _jax_drive(off, SD3_PLAN, 3)}
    span = _jax_engine("sd3", 2, mixed=True, cache=SPAN)
    outs["span"] = _jax_drive(span, SD3_PLAN, 4)
    return _port_bundle(off, "sd3"), outs


@pytest.mark.parametrize("case", ["off", "span"])
def test_sd3_token_path_against_jax_sp2(sd3_jax, case):
    bundle3, want = sd3_jax
    cache = SPAN if case == "span" else None
    pipe = _pipe(bundle3, "sd3", 2, cache=cache, mixed=True)
    trunk, modes = pipe._trunk_fn, []
    pipe._trunk_fn = lambda *a, **kw: (modes.append(kw.get("deep_mode")),
                                       trunk(*a, **kw))[1]
    got = _drive(pipe, SD3_PLAN, 4 if cache else 3, True)
    _close(got, want[case])
    if case == "span":
        assert modes[0] == "full" and "shallow" in modes
    else:
        assert modes == [None] * 3


SD3_CACHES = {
    "block": CacheConfig(enabled=True, mode="block", mse_threshold=0.05,
                         max_hits=2),
    "fine": CacheConfig(enabled=True, mode="compact", patch_fraction=0.5,
                        fine_stale_kv=True, max_hits=2),
}


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=["sp2", "sp2tp2"])
@pytest.mark.parametrize("case", sorted(SD3_CACHES))
def test_sd3_token_caches_follow_one_device(sd3_jax, picks, case, layout):
    bundle3, _ = sd3_jax
    cache = SD3_CACHES[case]
    one = _drive(_pipe(bundle3, "sd3", cache=cache, mixed=True), SD3_PLAN,
                 4, True)
    one_picks = list(picks[0])
    picks.clear()
    got = _drive(_pipe(bundle3, "sd3", *layout, cache=cache, mixed=True),
                 SD3_PLAN, 4, True)
    _close(got, one)
    assert_same_picks(picks, one_picks, *layout)


def _engine_caches(family):
    """The caches an sp=2 engine serves, by name (SD3's span within the
    tiny MMDiT's two blocks)."""
    span = {"sd3_deep_span": (1, 2)} if family == "sd3" else {}
    return {
        "default": None,
        "serving": dataclasses.replace(CacheConfig.production(family),
                                       **span),
        "offline": dataclasses.replace(
            CacheConfig.production(family, serving=False), **span),
        "block": CacheConfig(enabled=True, mode="block"),
        "compact": CacheConfig(enabled=True, mode="compact",
                               compact_fraction=0.5, patch_fraction=0.5,
                               fine_stale_kv=family == "sd3"),
    }


@pytest.fixture(scope="module")
def family_bundles():
    out = {}
    for family in ("sd15", "sdxl", "sd3"):
        b = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
        b.init_random(0)
        out[family] = b
    return out


@pytest.mark.parametrize("case", ["default", "serving", "offline", "block",
                                  "compact"])
@pytest.mark.parametrize("family", ["sd15", "sdxl", "sd3"])
def test_engine_serves_under_sp2(family_bundles, family, case):
    """``Engine(config, "cpu")`` at sp=2 on the family's default config
    (mixed batches on) with each cache: both production presets, modes
    "block" and "compact" (two-level rows on the patch path, the fine
    token gate with its stale K/V on SD3's token path), a 64^2 + 128^2
    batch of 3 steps: finite latents of each request."""
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.patch_size = PATCH
    if family == "sd3":
        config.model.resolutions = SD3_RES
    cache = _engine_caches(family)[case]
    if cache is not None:
        config.cache = cache
    config.parallel.sp = 2
    engine = Engine(config, "cpu", bundle=family_bundles[family])
    assert engine.workers[0].pipeline.group.sp == 2
    outs = _serve(engine, SamplingParams, MIXED, 3)
    assert len(outs) == 2 and all(np.isfinite(v).all()
                                  for v in outs.values())


# -- the state stays on its shard ---------------------------------------------

def _part_ptrs(tree) -> list:
    out = []
    if isinstance(tree, ShardedTensor):
        out += [(r, p.data_ptr()) for r, p in enumerate(tree.parts)
                if p is not None]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out += [(k,) + x for x in _part_ptrs(tree[k])]
    return out


def _step_ptrs(pipe, reqs, steps, mixed, store):
    out = []
    by_res = {}
    for r in reqs:
        by_res.setdefault(r.resolution, []).append(r)
    for _ in range(steps):
        (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(by_res)
        out.append([_part_ptrs(e) for e in store()])
    return out


@pytest.mark.parametrize("case", ["dense-compact", "mixed-hybrid",
                                  "mixed-block", "mixed-compact",
                                  "sd3-span", "sd3-fine"])
def test_row_state_stays_on_its_shard(bundle, sd3_jax, case):
    """Over two steps of a stable composition each shard's state tensors
    keep their storage: nothing is copied in from the lead device at a
    forward.  Each shard holds its own part, and ``/stats``'s per-shard
    bytes count every shard's (on the patch batch's block and compact
    rows, exactly the parts' bytes, half on each shard)."""
    family = "sd3" if case.startswith("sd3") else "sd15"
    mixed = case != "dense-compact"
    cache = {"dense-compact": DENSE_CACHES["compact"],
             "mixed-hybrid": CacheConfig.production("sd15", serving=False),
             "mixed-block": MIXED_CACHES["block"],
             "mixed-compact": MIXED_CACHES["compact-two-level"],
             "sd3-span": SPAN, "sd3-fine": SD3_CACHES["fine"]}[case]
    pipe = _pipe(sd3_jax[0] if family == "sd3" else bundle, family, 2,
                 cache=cache, mixed=mixed)
    plan = SD3_PLAN if family == "sd3" else (MIXED if mixed else DENSE[:1])
    reqs = _requests(plan, 8)
    pipe.prepare(reqs)
    if family == "sd3":
        def store():
            return [e["state"] if case == "sd3-fine" else e["deep"]
                    for e in pipe._sd3_state.values()]
    elif case in ("mixed-block", "mixed-compact"):
        def store():
            return [b.state for b in pipe._batch_rows.values()]
    else:
        def store():
            return [e["state"] for e in pipe._comp_state.values()]
    # past the anchoring and warmup steps, then two steady ones (the span
    # delta's: two shallow steps)
    ptrs = _step_ptrs(pipe, reqs, 3 if case == "sd3-span" else 4, mixed,
                      store)
    if case == "sd3-fine":  # the stale K/V rows are new each step
        ptrs = [[[p for p in e if p[1] not in ("k", "v", "k2", "v2")]
                 for e in step] for step in ptrs]
    assert ptrs[-1] and ptrs[-1][0], "no sharded state"
    assert ptrs[-1] == ptrs[-2]
    ranks = {p[-2] for p in ptrs[-1][0]}
    assert ranks == {0, 1}
    per_shard = pipe.shard_state_bytes()
    assert len(per_shard) == 2 and min(per_shard) > 0
    if case in ("mixed-block", "mixed-compact"):
        parts = [0, 0]
        for tree in store():
            for leaf in _leaves(tree):
                for r, p in enumerate(leaf.parts):
                    parts[r] += p.numel() * p.element_size()
        assert per_shard == parts and parts[0] == parts[1]
        assert pipe._live_state_bytes() == sum(parts)
        assert all(r.cache_rows is None for r in reqs)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        assert isinstance(tree, ShardedTensor), type(tree)
        yield tree


# -- chunks under sp ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["gspmd", "displaced"])
def test_mixed_chunk_under_sp(bundle, mode):
    """A k-step chunk of the patch batch under sp runs k eager sharded
    steps, equal to k single steps; under ``sp_mode="displaced"`` it is
    refused, as in JAX, and the worker steps once."""
    cache = MIXED_CACHES["compact-two-level"]
    pipe = _pipe(bundle, "sd15", 2, cache=cache, mixed=True, mode=mode)
    reqs = _requests(MIXED, 4)
    pipe.prepare(reqs)
    by_res = {64: reqs[:1], 128: reqs[1:]}
    ran = pipe.denoise_chunk_mixed(by_res, 3)
    assert ran == (mode == "gspmd")
    if not ran:
        return
    assert [r.remain_steps for r in reqs] == [1, 1]
    assert not pipe.denoise_chunk_mixed(by_res, 3)  # one step left
    pipe.denoise_step_mixed(by_res)
    got = {r.request_id: np.asarray(r.latents[0], np.float32) for r in reqs}
    _close(got, _drive(_pipe(bundle, "sd15", cache=cache, mixed=True),
                       MIXED, 4, True))
