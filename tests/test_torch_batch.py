"""K1 with a batch axis: ``min_scores_fused`` on a wave's
``[B, T, 16, D]`` cube, one launch per F1 wave, and the posting
scatter without a validity tensor.

On the CPU the batched wrapper takes the plain version once per query;
each query of the wave is held against the JAX package's
``scorer.min_scores`` at D ∈ {1000, 1001} and against its Pallas K1 in
interpret mode at D = 1024 (the Pallas kernel needs D % 1024 == 0). The
``cuda`` cases hold the CUDA kernels bitwise against their plain
versions at D = 1001 (rows that are not 16-byte aligned and a ragged last
tile); they skip without a card. This file imports JAX only inside the
tests that compare with it, so the ``cuda`` cases also run on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_batch.py
-m cuda``."""

import os

import numpy as np
import pytest
import torch

from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (
    ROUTE_ENV, fd_inputs, rand_cube, route_docs)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import fd_scores_kernel as fdk
from open_source_search_engine_tpu_torch.query import min_scores_kernel as msk
from open_source_search_engine_tpu_torch.query import scorer
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex

#: the tier-1 run shares the host's cores among several workers, and
#: these small tensors gain nothing from intra-op threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)
P = 16


def _wave(B, T, D, seed):
    """A wave as numpy: cube [B, T, 16, D] uint32 (validity = payload ≠
    0), freq_weight [B, T] float32, counts [B, T] bool."""
    rng = np.random.default_rng(seed)
    cube = np.stack([rand_cube(rng, T, D) for _ in range(B)])
    fw = (rng.random((B, T)) * 0.5 + 0.2).astype(np.float32)
    counts = rng.random((B, T)) < 0.7
    counts[:, 0] = True
    return cube, fw, counts


def _torch(cube, fw, counts, device="cpu"):
    return (torch.from_numpy(np.ascontiguousarray(cube).view(np.int32)).to(
        device), torch.from_numpy(fw).to(device),
        torch.from_numpy(counts).to(device))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")


WAVES = [(B, T) for B in (1, 3) for T in (4, 8)]


@pytest.mark.parametrize("D", [1000, 1001])
@pytest.mark.parametrize("B,T", WAVES)
def test_batched_matches_jnp(B, T, D):
    import jax.numpy as jnp
    from open_source_search_engine_tpu.query import scorer as jscorer
    cube, fw, counts = _wave(B, T, D, seed=B * 100 + T + D)
    got = msk.min_scores_fused(*_torch(cube, fw, counts))
    assert got.shape == (B, D)
    for b in range(B):
        ref, _ = jscorer.min_scores(
            jnp.asarray(cube[b]), jnp.asarray(cube[b] != 0),
            jnp.asarray(fw[b]), jnp.asarray(counts[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"query {b}")


@pytest.mark.parametrize("B,T", WAVES)
def test_batched_matches_pallas_interpret(B, T):
    import jax.numpy as jnp
    from open_source_search_engine_tpu.query.pallas_scores import \
        min_scores_fused as jax_min_scores_fused
    D = 1024
    cube, fw, counts = _wave(B, T, D, seed=7 + B * 10 + T)
    got = msk.min_scores_fused(*_torch(cube, fw, counts))
    for b in range(B):
        ref = jax_min_scores_fused(jnp.asarray(cube[b]), jnp.asarray(fw[b]),
                                   jnp.asarray(counts[b]), interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"query {b}")


def test_batched_takes_plain_version_per_query_on_cpu():
    cube, fw, counts = _wave(3, 4, 256, seed=1)
    c, f, k = _torch(cube, fw, counts)
    before_l, before_p = msk.launches, msk.plain_calls
    got = msk.min_scores_fused(c, f, k)
    assert msk.launches == before_l == 0
    assert msk.plain_calls == before_p + 3
    for b in range(3):
        assert torch.equal(got[b], msk.min_scores_fused(c[b], f[b], k[b]))


def test_scorer_min_scores_batched_shapes():
    B, T, D = 3, 8, 300
    cube, fw, counts = _wave(B, T, D, seed=2)
    c, f, k = _torch(cube, fw, counts)
    ms, present = scorer.min_scores(c, c != 0, f, k)
    assert ms.shape == (B, D) and present.shape == (B, T, D)
    for b in range(B):
        ms_b, present_b = scorer.min_scores(c[b], c[b] != 0, f[b], k[b])
        assert torch.equal(ms[b], ms_b)
        assert torch.equal(present[b], present_b)


def test_batched_rejects_other_devices():
    c = torch.zeros((2, 4, 16, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        msk.min_scores_fused(c, torch.zeros(2, 4, device="meta"),
                             torch.ones(2, 4, dtype=torch.bool,
                                        device="meta"))


# ---- the device route: one K1 call per F1 wave, the FD scatter

@pytest.fixture(scope="module")
def route_index(tmp_path_factory):
    """A port DeviceIndex on the CPU over route_docs(48) under ROUTE_ENV
    (F1, FD and F2 each serve a query), with the environment restored
    after the module."""
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    try:
        coll = Collection("batch", tmp_path_factory.mktemp("tbatch"),
                          device="cpu")
        docproc.index_batch(coll, route_docs(48))
        coll.posdb.dump()
        coll.titledb.dump()
        yield DeviceIndex(coll, device="cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_one_k1_call_per_f1_wave(route_index, monkeypatch):
    """K1's calls on the route equal the F1 wave calls plus the F2
    queries: phase 2 scores the whole wave in one call."""
    di = route_index
    calls = {"k1": 0, "f1": 0, "f2": 0, "f1_queries": 0}
    fused = scorer.min_scores_fused
    run_f1, run_f2 = di._run_batch, di._run_batch_f2

    def count_k1(*args, **kw):
        calls["k1"] += 1
        return fused(*args, **kw)

    def count_f1(plans, *args):
        calls["f1"] += 1
        calls["f1_queries"] += len(plans)
        return run_f1(plans, *args)

    def count_f2(plans, *args):
        calls["f2"] += len(plans)
        return run_f2(plans, *args)
    monkeypatch.setattr(scorer, "min_scores_fused", count_k1)
    monkeypatch.setattr(di, "_run_batch", count_f1)
    monkeypatch.setattr(di, "_run_batch_f2", count_f2)
    queries = ["zeta", "alpha", "beta", "gamma", "dogs", "boxes dogs",
               "alpha beta"]
    routes0 = dict(di.route_counts)
    di.search_batch(queries, topk=64)
    routes = {k: di.route_counts[k] - routes0[k] for k in routes0}
    assert routes["f1"] >= 2 and routes["f2"] >= 1, routes
    assert calls["f1_queries"] > calls["f1"], calls  # a wave of several
    assert calls["k1"] == calls["f1"] + calls["f2"], calls


def test_fd_scatter_skips_validity(route_index):
    """The posting scatter builds no validity tensor: it returns the cube
    alone (validity is payload ≠ 0), and a wave's scatter holds each
    query's postings at that query's offset, as a scatter of the query
    alone does."""
    di = route_index
    plans = [di.plan(compile_query(q)) for q in ("alpha beta", "alpha gamma",
                                                 "alpha beta gamma")]
    T = max(len(p.required) for p in plans)
    one = T * P * di.D_cap
    cube = di._scatter_postings(plans, T, len(plans) * one)
    assert isinstance(cube, torch.Tensor) and cube.dtype == torch.int32
    assert cube.shape == (len(plans) * one + 1,)
    assert int((cube[:-1] != 0).sum()) > 0
    for b, p in enumerate(plans):
        alone = di._scatter_postings([p], T, one)
        assert torch.equal(cube[b * one:(b + 1) * one], alone[:-1]), b


# ---- on the card: the kernels against their plain versions at D = 1001

@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 8, 16, 32])
def test_k1_batched_ragged_on_card(T):
    _card()
    cube, fw, counts = _wave(3, T, 1001, seed=T)
    c, f, k = _torch(cube, fw, counts, "cuda")
    got = msk.min_scores_fused(c, f, k)
    torch.cuda.synchronize()
    for b in range(3):
        want = msk.min_scores_plain(c[b], c[b] != 0, f[b], k[b])
        assert torch.equal(got[b], want), (T, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("T", [4, 8])
def test_k2_ragged_on_card(T, tail):
    _card()
    args = tuple(None if a is None else
                 torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in fd_inputs(np.random.default_rng(30 + T), T, 1001,
                                    tail, B=3))
    ms, pres = fdk.fd_scores(*args)
    want_ms, want_pres = fdk.fd_scores_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ms, want_ms)
    assert torch.equal(pres, want_pres)
