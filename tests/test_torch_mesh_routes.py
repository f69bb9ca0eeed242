"""Every kernel route of the port's mesh, against the JAX package's mesh
and the port's flat path (CPU).

The scenarios of ``tests/test_mesh_routes.py``: under ``ROUTE_ENV`` the
route corpus (``route_docs(48·8)``) over 8 shards gives every shard a
real base with dense and cube rows, and each query of ``ROUTE_QUERIES``
takes its route (F1, FD, F2) on all 8 shards of ``MeshResident``. Its
pages equal ``sharded_search``'s and the JAX ``MeshResident``'s (totals
exact, scores rtol=1e-5, docids by complete tie runs), the per-shard
route counts equal the JAX package's, and totals and scores equal the
port's flat path (rtol=1e-5); the κ escalation runs."""

import os

import pytest
import torch

from open_source_search_engine_tpu.parallel import sharded as jsharded
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.corpus import (
    ROUTE_ENV, ROUTE_QUERIES, assert_tie_run_parity, route_docs)
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.parallel import (
    MeshResident, ShardedCollection, sharded_search)
from open_source_search_engine_tpu_torch.query import engine
from tests import jax_gc
from tests.test_torch_parallel import _page

torch.set_num_threads(1)

N_SHARDS = 8


@pytest.fixture(scope="module", autouse=True)
def _gc_quiet():
    with jax_gc.quiet():
        yield


@pytest.fixture(scope="module")
def mesh_env(tmp_path_factory):
    """The port grid and its MeshResident, the JAX grid and its
    MeshResident, and a port flat collection over the route corpus,
    built under ROUTE_ENV; released and dropped at the end (the module's
    collection runs after, with no lock held)."""
    saved = {k: os.environ.get(k) for k in ROUTE_ENV}
    os.environ.update(ROUTE_ENV)
    objs = {}
    try:
        docs = route_docs(48 * N_SHARDS)
        for key, cls, kw in (("sc", ShardedCollection, dict(device="cpu")),
                             ("jsc", jsharded.ShardedCollection, {})):
            objs[key] = sc = cls("mesh", tmp_path_factory.mktemp("grid"),
                                 n_shards=N_SHARDS, **kw)
            for url, html in docs:
                sc.index_document(url, html)
            for sh in sc.shards:
                sh.posdb.dump()
                sh.titledb.dump()
                sh.save()
        del sc
        objs["flat"] = Collection("mesh", tmp_path_factory.mktemp("flat"),
                                  device="cpu")
        docproc.index_batch(objs["flat"], docs)
        objs["flat"].posdb.dump()
        objs["flat"].titledb.dump()
        objs["mr"] = MeshResident(objs["sc"], devices=["cpu"])
        objs["jmr"] = jsharded.MeshResident(objs["jsc"])
        yield objs
    finally:
        jax_gc.release(*(objs[k] for k in ("mr", "jmr") if k in objs))
        objs.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _hits(indexes, fn):
    before = {k: [di.route_counts[k] for di in indexes]
              for k in ("f1", "fd", "f2")}
    out = fn()
    return out, {k: [di.route_counts[k] - b for di, b in
                     zip(indexes, before[k])] for k in before}


def test_every_shard_has_a_real_base(mesh_env):
    for s, di in enumerate(mesh_env["mr"].indexes):
        assert di.n_docs > 0, s
        assert len(di.dense_slot_of) > 0, s
        assert len(di.cube_slot_of) > 0, s
    assert [di.n_docs for di in mesh_env["mr"].indexes] == \
        [di.n_docs for di in mesh_env["jmr"].indexes]


@pytest.mark.parametrize("q,route", list(ROUTE_QUERIES.items()))
def test_route_and_golden(mesh_env, q, route):
    mr, jmr = mesh_env["mr"], mesh_env["jmr"]
    _, hits = _hits(mr.indexes, lambda: mr.search(q, topk=8))
    _, jhits = _hits(jmr.indexes, lambda: jmr.search(q, topk=8))
    assert hits[route] == [1] * N_SHARDS, (q, hits)
    assert hits == jhits, (q, hits, jhits)
    # site clustering off: equal-score ties sit side by side
    r_mesh = mr.search(q, topk=8, site_cluster=False)
    r_map = sharded_search(mesh_env["sc"], q, topk=8, site_cluster=False)
    r_ref = jmr.search(q, topk=8, site_cluster=False)
    r_flat = engine.search(mesh_env["flat"], q, topk=8, site_cluster=False)
    for other, label in ((r_map, "sharded_search"), (r_ref, "jax mesh")):
        assert_tie_run_parity(_page(r_mesh), _page(other), (q, label))
    assert r_mesh.total_matches == r_flat.total_matches, q
    assert_tie_run_parity(_page(r_mesh), _page(r_flat), (q, "flat"))


def test_escalation_exercised(mesh_env):
    mr, jmr = mesh_env["mr"], mesh_env["jmr"]
    esc0 = [di.escalations for di in mr.indexes]
    jesc0 = [di.escalations for di in jmr.indexes]
    mr.search("alpha", topk=8)
    jmr.search("alpha", topk=8)
    esc = [di.escalations - e for di, e in zip(mr.indexes, esc0)]
    assert sum(esc) > 0
    assert esc == [di.escalations - e for di, e in zip(jmr.indexes, jesc0)]
