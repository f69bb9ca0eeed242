"""K2 (the FD route's scoring kernel) on the CPU: the port's plain
version ``fd_scores_plain`` against the JAX package's FD route — the
Pallas kernel ``_fd_call`` in interpret mode (``OSSE_PALLAS=force``) and
the unfused jnp assembly plus ``scorer.min_scores`` (``OSSE_PALLAS=0``)
— on the same random resident cubes, with and without a posting tail,
and end to end through both packages' ``DeviceIndex`` on the route
corpus. The CUDA kernel itself runs only on the card (``-m cuda``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_source_search_engine_tpu.build import docproc as jdocproc
from open_source_search_engine_tpu.index.collection import \
    Collection as JCollection
from open_source_search_engine_tpu.query import devindex as jdv
from open_source_search_engine_tpu.query import scorer as jscorer
from open_source_search_engine_tpu.query.pallas_scores import (
    fd_scores_fused, fd_scores_fused_notail)
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (ROUTE_ENV,
                                                        fd_inputs,
                                                        route_docs)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query.compiler import compile_query
from open_source_search_engine_tpu_torch.query import fd_scores_kernel as fdk
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex
from tests import jax_gc

#: the tier-1 run shares the host's cores among several workers, and
#: these small tensors gain nothing from intra-op threads
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    """No cyclic collection while this module drives the JAX package's
    device index (``tests/jax_gc.py``)."""
    with jax_gc.quiet():
        yield


#: the tolerance tests/test_pallas.py::TestFusedEndToEnd holds the fused
#: route to (the Pallas body sums in another order)
RTOL = 1e-5
P = 16
D = 1024
B = 3
VC = 6   # resident cube slots; the last stays all-zero


def _inputs(T, tail, seed):
    """Random FD inputs as numpy (``corpus.fd_inputs``, drawn as the
    reference's ``_rand_cube`` draws): a resident cube [VC·P·D] uint32
    with a zero last slot, quarter indices (some on the zero slot),
    synonym flags, dead docs, weights, and an optional sparse tail
    [B, T, P, D] uint32."""
    gq, gs, cube, dead, fw, counts, tl = fd_inputs(
        np.random.default_rng(seed), T, D, tail, B=B, Vc=VC)
    return (cube.view(np.uint32), gq, gs, dead, fw, counts,
            None if tl is None else tl.view(np.uint32))


def _port(cube, gq, gs, dead, fw, counts, tl):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return fdk.fd_scores(
        t(gq), t(gs), t(cube.view(np.int32)), t(dead), t(fw), t(counts),
        None if tl is None else t(tl.view(np.int32)))


def _bits_of(present):
    """[B, T, D] bool → [B, D] int32 presence bitmask."""
    T = present.shape[1]
    return (present.astype(np.int32) << np.arange(T)[None, :, None]).sum(1)


def _jnp_reference(cube, gq, gs, dead, fw, counts, tl):
    """The JAX package's unfused FD semantics (``_direct_cube`` assembly,
    then ``scorer.min_scores``), per query."""
    T = gq.shape[1] // 4
    rows = jnp.asarray(cube).reshape(-1, P // 4 * D)
    ms, pres = [], []
    for b in range(B):
        r = rows[jnp.asarray(gq[b])].reshape(T, 4, P // 4, D)
        syn = (jnp.asarray(gs[b]).astype(jnp.uint32)
               << jnp.uint32(31)).reshape(T, 4)[:, :, None, None]
        r = jnp.where(r != 0, r | syn, r).reshape(T, P, D)
        c = jnp.where(jnp.asarray(dead)[None, None, :], jnp.uint32(0), r)
        if tl is not None:
            c = c | jnp.asarray(tl[b])
        m, present = jscorer.min_scores(c, c != 0, jnp.asarray(fw[b]),
                                        jnp.asarray(counts[b]))
        ms.append(np.asarray(m))
        pres.append(np.asarray(present))
    return np.stack(ms), _bits_of(np.stack(pres))


# The cases loop inside each test rather than parametrizing: the tier-1
# run schedules whole files by test count, largest first, and a file of a
# few tests keeps to the end of that order.
CASES = [(T, tail) for T in (4, 8) for tail in (False, True)]


def test_plain_matches_pallas_interpret():
    """OSSE_PALLAS=force: the Pallas K2 in interpret mode."""
    for T, tail in CASES:
        cube, gq, gs, dead, fw, counts, tl = _inputs(T, tail, seed=T + tail)
        args = (jnp.asarray(gq), jnp.asarray(gs), jnp.asarray(cube))
        rest = (jnp.asarray(dead.astype(np.int32)).reshape(1, D),
                jnp.asarray(fw), jnp.asarray(counts.astype(np.float32)))
        if tail:
            ref_ms, ref_pres = fd_scores_fused(
                *args, jnp.asarray(tl), *rest, T=T, P=P, interpret=True)
        else:
            ref_ms, ref_pres = fd_scores_fused_notail(
                *args, *rest, T=T, P=P, interpret=True)
        ms, pres = _port(cube, gq, gs, dead, fw, counts, tl)
        np.testing.assert_allclose(ms.numpy(), np.asarray(ref_ms),
                                   rtol=RTOL, err_msg=str((T, tail)))
        np.testing.assert_array_equal(pres.numpy(), np.asarray(ref_pres))


def test_plain_matches_unfused_jnp():
    """OSSE_PALLAS=0: the unfused assembly and the jnp min-score chain."""
    for T, tail in CASES:
        inputs = _inputs(T, tail, seed=10 + T + tail)
        ref_ms, ref_pres = _jnp_reference(*inputs)
        ms, pres = _port(*inputs)
        np.testing.assert_allclose(ms.numpy(), ref_ms, rtol=RTOL,
                                   err_msg=str((T, tail)))
        np.testing.assert_array_equal(pres.numpy(), ref_pres)


def test_wrapper_takes_plain_version_on_cpu_only():
    inputs = _inputs(4, True, seed=3)
    before = fdk.plain_calls
    k_before = (fdk.launches_tail, fdk.launches_notail)
    _port(*inputs)
    assert fdk.plain_calls == before + 1
    assert (fdk.launches_tail, fdk.launches_notail) == k_before
    meta = torch.empty(4 * P * D, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fdk.fd_scores(torch.zeros(1, 16, dtype=torch.int32),
                      torch.zeros(1, 16, dtype=torch.int32), meta,
                      torch.zeros(D, dtype=torch.bool),
                      torch.ones(1, 4), torch.ones(1, 4, dtype=torch.bool))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    for T, tail in CASES:
        cube, gq, gs, dead, fw, counts, tl = _inputs(T, tail, seed=20 + T)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        args = (t(gq), t(gs), t(cube.view(np.int32)), t(dead), t(fw),
                t(counts), None if tl is None else t(tl.view(np.int32)))
        ms, pres = fdk.fd_scores(*args)
        want_ms, want_pres = fdk.fd_scores_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(ms, want_ms), (T, tail)
        assert torch.equal(pres, want_pres), (T, tail)


# ---- end to end: the FD route through both packages' DeviceIndex

FD_QUERIES = ["alpha beta", "alpha gamma", "alpha beta gamma", "boxes dogs",
              "alpha", "zeta"]


@pytest.fixture(scope="module")
def route_pair(tmp_path_factory):
    """(JAX DeviceIndex, port DeviceIndex) over route_docs(256) under
    ROUTE_ENV, plus a delta doc so FD queries carry a posting tail."""
    saved = {k: os.environ.get(k) for k in list(ROUTE_ENV) + ["OSSE_PALLAS"]}
    os.environ.update(ROUTE_ENV)
    try:
        docs = route_docs(256, "pal")
        jc = JCollection("fd", tmp_path_factory.mktemp("tfd_j"))
        tc = Collection("fd", tmp_path_factory.mktemp("tfd_t"),
                        device="cpu")
        jdocproc.index_batch(jc, docs)
        docproc.index_batch(tc, docs)
        for c in (jc, tc):
            c.posdb.dump()
            c.titledb.dump()
        fresh = ("http://fresh.test/x", "<html><head><title>Fresh</title>"
                 "</head><body><p>alpha beta gamma fresh.</p></body></html>")
        jdocproc.index_document(jc, *fresh)
        docproc.index_document(tc, *fresh)
        yield jdv.DeviceIndex(jc), DeviceIndex(tc)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jdv._direct_cube.clear_cache()


def test_fd_route_matches_reference(route_pair):
    for flag in ("force", "0"):
        _fd_route_matches(*route_pair, flag)


def _fd_route_matches(jdi, tdi, flag):
    os.environ["OSSE_PALLAS"] = flag
    jdv._direct_cube.clear_cache()
    plans = [tdi.plan(compile_query(q)) for q in FD_QUERIES]
    assert any(p.direct_ok and len(p.p_start) for p in plans)  # a tail
    tdi.route_counts = {"f1": 0, "fd": 0, "f2": 0}
    jdi.route_counts = {"f1": 0, "fd": 0, "f2": 0}
    got = tdi.search_batch(FD_QUERIES, topk=8)
    want = jdi.search_batch(FD_QUERIES, topk=8)
    assert tdi.route_counts == jdi.route_counts
    assert tdi.route_counts["fd"] >= 2
    for q, a, b in zip(FD_QUERIES, got, want):
        assert a[2] == b[2], (flag, q)
        np.testing.assert_allclose(a[1], b[1], rtol=RTOL,
                                   err_msg=f"{flag} {q}")
        for r in range(len(b[1])):
            tied = ((r > 0 and b[1][r - 1] == b[1][r])
                    or (r + 1 < len(b[1]) and b[1][r + 1] == b[1][r]))
            if not tied:
                assert a[0][r] == b[0][r], (flag, q, r)
