"""Sharded collection and the scatter-gather query over a device mesh.

Port of ``open_source_search_engine_tpu/parallel/sharded.py`` (reference
SURVEY §2.5, §3.2):

* **Document partitioning** (``Hostdb::getShardNum``
  ``Hostdb.cpp:2486``; checksum terms by termid, ``Hostdb.cpp:2468``):
  :class:`ShardedCollection` splits each document's records across
  per-shard Collections with the same hash functions, every twin of a
  shard taking every write.
* **Msg39 per shard, Msg3a merge** (``Msg39.cpp:74``, ``Msg3a.cpp:971``):
  the reference scores each shard on its own chip inside a ``shard_map``
  program and all-gathers the per-shard top-k for the merge. Here the
  shards' ``[S, B, ...]`` host-packed stacks are scored as one batched
  cube of S·B rows, with one min-score (K1) launch per wave for each
  distinct device of the mesh (one launch when every shard lives on one
  card); the per-shard top-k blocks then meet on the mesh's first device
  for one batched :func:`~..query.scorer.merge_dedup_topk`.
* **Msg20 summaries**: titlerec reads go to the shard owning the docid.

:class:`MeshResident` serves from one resident ``DeviceIndex`` per shard
(the host merge, ``search_batch``, with the F1/F2/FD waves and K2 on each
shard) or through a ResidentLoop over :class:`MeshServeIndex` (the
in-program merge with the 2-per-site dedup, ``serve_batch``). Every shard
plans and scores with cluster-wide term frequencies and doc counts.

Telemetry: with devwatch on, a mesh wave's staged operands are a
``mesh_stage`` buffer of the HBM ledger from issue to collect (slot keys
cycle mod 8), and each collect notes its round (device wait, fetched
bytes, the merge window and its re-merges as escalations); the uploads
report to jitwatch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..build import docproc
from ..device import resolve_device
from ..index.collection import Collection
from ..index.tagdb import Tagdb
from ..query import weights
from ..query.compiler import QueryPlan, compile_query
from ..query.engine import (MAX_PER_SITE, PQR_SCAN, SearchResults,
                            _coll_langid_of, build_device_index,
                            build_results, compute_facets, finish_page,
                            spawn_resident_loop)
from ..query.packer import (MAX_POSITIONS, PackedQuery, PreparedQuery,
                            _bucket, _pad1, group_flags, local_sort_base,
                            pack_pass, pad_table, prepare_query)
from ..query.scorer import merge_dedup_topk, score_core, top_k
from ..utils import devwatch, jitwatch, trace
from ..utils.log import get_logger
from ..utils.membudget import g_membudget
from ..utils.url import normalize
from .hostmap import HostMap, make_mesh

log = get_logger("parallel")


def _docid_of(url: str) -> int:
    from ..utils import ghash
    return ghash.doc_id(normalize(url).full)


class ShardedTagdb(Tagdb):
    """Tag records routed by site to their owning shard (``Tagdb.h:323``):
    writes go to every twin, reads to the serving replica; the container
    walk (``get_tag``, ``tag_rec``, ``site_of``, ``index_gate``) is the
    base class's."""

    def __init__(self, sc: "ShardedCollection"):
        self._sc = sc  # no local Rdb: per-site routing below

    @property
    def empty(self) -> bool:
        return all(c.tagdb.empty for row in self._sc.grid for c in row)

    def _shard_of(self, site: str) -> int:
        return int(self._sc.hostmap.shard_of_site(site))

    def set_tag(self, site: str, name: str, value,
                user: str = "admin") -> None:
        for c in self._sc.replicas_of(self._shard_of(site)):
            c.tagdb.set_tag(site, name, value, user)

    def remove_tag(self, site: str, name: str) -> None:
        for c in self._sc.replicas_of(self._shard_of(site)):
            c.tagdb.remove_tag(site, name)

    def tags_for_site(self, site: str) -> dict[str, object]:
        return self._sc.shards[self._shard_of(site)].tagdb \
            .tags_for_site(site)

    def save(self) -> None:  # each shard's Collection saves its own
        pass


class ShardedCollection:
    """One logical collection over ``n_shards`` shards × ``n_replicas``
    twins, each a full Collection under ``base_dir/shard_XXX[_rR]/`` (one
    gb instance's working directory). ``device`` is where the shards
    score (``None`` means ``cuda``; pass ``"cpu"`` to run on the CPU)."""

    def __init__(self, name: str, base_dir: str | Path, n_shards: int,
                 n_replicas: int = 1, device=None):
        self.name = name
        self.base_dir = Path(base_dir)
        self.device = resolve_device(device)
        self.hostmap = HostMap(n_shards, n_replicas)
        # grid[s][r]: replica r of shard s (the reference's twins);
        # replica 0 keeps the unsuffixed directory
        self.grid = [
            [Collection(name, self.base_dir /
                        (f"shard_{s:03d}" if r == 0
                         else f"shard_{s:03d}_r{r}"), device=self.device)
             for r in range(n_replicas)]
            for s in range(n_shards)
        ]
        #: monotonic corpus mutation counter (moves the mesh generation
        #: even where a replace leaves num_docs as it was)
        self.mutations = 0
        #: site-routed tag store (bans, boundaries, overrides)
        self.tagdb = ShardedTagdb(self)
        # a host pressure handler (no device label): an over-budget
        # reserve() dumps the grid's fattest memtables before it refuses
        g_membudget.add_pressure_handler(self._relieve_memory)

    def _relieve_memory(self, need: int) -> int:
        """Dump the grid's largest memtables until ~``need`` bytes are
        freed."""
        freed = 0
        rdbs = [rdb for row in self.grid for coll in row
                for rdb in coll.rdbs().values()
                if rdb.mem.nbytes >= 1 << 20]
        rdbs.sort(key=lambda r: r.mem.nbytes, reverse=True)
        for rdb in rdbs:
            if freed >= need:
                break
            freed += rdb.mem.nbytes
            rdb.dump()
        if freed:
            log.info("budget pressure: dumped %d MB of memtables",
                     freed >> 20)
        return freed

    @property
    def n_shards(self) -> int:
        return self.hostmap.n_shards

    @property
    def shards(self) -> list[Collection]:
        """The serving replica per shard; replica 0 where the whole shard
        is dead (the query layer checks liveness itself)."""
        return [self.grid[s][self.hostmap.serving_replica(s) or 0]
                for s in range(self.n_shards)]

    def replicas_of(self, shard: int) -> list[Collection]:
        """Every twin of a shard: the write fan-out (``Msg1.cpp:20``)."""
        return self.grid[shard]

    @property
    def num_docs(self) -> int:
        return sum(row[0].num_docs for row in self.grid)

    # --- writes: records routed by shard (Msg4 / Msg1) ---

    def _linkdb_of(self, site: str):
        """The serving linkdb of a site's records (linkee-site routed)."""
        return self.shards[self.hostmap.shard_of_site(site)].linkdb

    def _linkdbs_all(self, site: str):
        return [c.linkdb for c in
                self.replicas_of(self.hostmap.shard_of_site(site))]

    def site_num_inlinks(self, site: str) -> int:
        return self._linkdb_of(site).site_num_inlinks(site)

    def index_document(self, url: str, content: str, *, is_html: bool = True,
                       siterank: int = 0, langid: int | None = None,
                       propagate: bool = True):
        """Index one document, its records scattered to their shards:
        posdb keys by docid (checksum terms by termid), titledb, clusterdb
        and fielddb to the docid's shard, sectiondb to the site's, linkdb
        edges to the linkee site's. None for a banned page."""
        u = normalize(url)
        banned, site, sr_override = self.tagdb.index_gate(u)
        if banned:
            self.remove_document(url, propagate=propagate)
            return None
        if sr_override is not None:
            siterank = sr_override
        self.mutations += 1
        old = self.remove_document(url, propagate=False)
        inlinks = self._linkdb_of(site).inlinks_for_url(site, u.full)
        from ..build.tokenizer import tokenize_html, tokenize_text
        tdoc = (tokenize_html(content, u.full) if is_html
                else tokenize_text(content))
        sect_shard = int(self.hostmap.shard_of_site(site))
        boiler = self.shards[sect_shard].sectiondb.boiler_set(
            site, docproc.doc_section_hashes(tdoc).values())
        ml = docproc.build_meta_list(url, content, is_html=is_html,
                                     siterank=siterank, langid=langid,
                                     inlinks=inlinks, site=site,
                                     site_resolver=self.tagdb.site_of,
                                     tdoc=tdoc, boiler_sections=boiler)
        home = int(self.hostmap.shard_of_docid(ml.docid))
        key_shards = self.hostmap.shard_of_keys(ml.posdb_keys)
        for s in np.unique(key_shards):
            for coll in self.replicas_of(int(s)):
                coll.posdb.add(ml.posdb_keys[key_shards == s])
        for coll in self.replicas_of(home):
            coll.titledb.add(ml.titledb_key.reshape(1), [ml.title_rec])
            coll.clusterdb.add(ml.clusterdb_key.reshape(1))
            if ml.fielddb_keys is not None and len(ml.fielddb_keys):
                coll.fielddb.add(ml.fielddb_keys, ml.fielddb_blobs)
            coll.titlerec_cache.pop(ml.docid, None)
            coll.doc_added()
            if ml.words:
                coll.speller.add_doc_words(ml.words)
        for coll in self.replicas_of(sect_shard):
            coll.sectiondb.add_page_sections(site, u.full, ml.sections)
        for linkee, anchor in ml.edges:
            lk_site = ml.edge_sites.get(linkee.full, linkee.site)
            for ldb in self._linkdbs_all(lk_site):
                ldb.add_link(
                    lk_site, site, u.full, linkee_url=linkee.full,
                    anchor_text=anchor, linker_siterank=siterank)
        ml.refresh_targets = [e[0] for e in ml.edges]
        if old:
            ml.refresh_targets += old.refresh_targets
        if propagate:
            self._refresh_linkees(ml.refresh_targets, site)
        return ml

    def _refresh_linkees(self, linkees, own_site: str) -> None:
        from ..spider.linkdb import site_rank
        docproc.refresh_linkees(
            linkees, own_site,
            get_doc=lambda lk: self.get_document(_docid_of(lk.full)),
            linkdb_of=self._linkdb_of,
            reindex=lambda lk, rec: self.index_document(
                lk.full, rec.get("content", rec["text"]),
                is_html=rec.get("is_html", True),
                siterank=site_rank(self.site_num_inlinks(
                    self.tagdb.site_of(lk))),
                langid=rec.get("langid"), propagate=False),
            site_of=self.tagdb.site_of)

    def remove_document(self, url: str, propagate: bool = True):
        """Tombstone a document's records on every twin of their shards;
        None when it is not indexed."""
        from ..spider.linkdb import pack_key as link_key
        self.mutations += 1
        docid = _docid_of(url)
        home = int(self.hostmap.shard_of_docid(docid))
        rec = docproc.get_document(self.shards[home], url=url)
        if rec is None:
            return None
        dead = docproc.tombstone_meta_list(rec)
        key_shards = self.hostmap.shard_of_keys(dead.posdb_keys)
        for s in np.unique(key_shards):
            for coll in self.replicas_of(int(s)):
                coll.posdb.add(dead.posdb_keys[key_shards == s])
        for coll in self.replicas_of(home):
            coll.titledb.add(dead.titledb_key.reshape(1), [b""])
            coll.clusterdb.add(dead.clusterdb_key.reshape(1))
            if dead.fielddb_keys is not None and len(dead.fielddb_keys):
                coll.fielddb.add(dead.fielddb_keys, dead.fielddb_blobs)
            coll.titlerec_cache.pop(dead.docid, None)
            if dead.words:
                coll.speller.remove_doc_words(dead.words)
            coll.doc_removed()
        u = normalize(url)
        for coll in self.replicas_of(
                int(self.hostmap.shard_of_site(dead.site))):
            coll.sectiondb.remove_page_sections(
                dead.site, u.full, rec.get("sections") or [])
        for linkee, _anchor in dead.edges:
            # deleted under the boundary frozen at add time
            lk_site = dead.edge_sites.get(linkee.full) \
                or self.tagdb.site_of(linkee)
            if lk_site == dead.site:
                continue
            for ldb in self._linkdbs_all(lk_site):
                ldb.rdb.delete(
                    link_key(lk_site, linkee.full, dead.site,
                             u.full).reshape(1))
        dead.refresh_targets = [e[0] for e in dead.edges]
        if propagate:
            self._refresh_linkees(dead.refresh_targets, dead.site)
        return dead

    def get_document(self, docid: int) -> dict | None:
        """Msg22 titlerec fetch from the owning shard."""
        home = int(self.hostmap.shard_of_docid(docid))
        return docproc.get_document(self.shards[home], docid=docid)

    # --- twin patching and replica resync (Msg5 error correction) ---

    def scrub(self) -> dict[str, list[str]]:
        """Integrity sweep of every replica's every Rdb; corrupt runs are
        quarantined, then healed from a live twin. Every replica is
        scrubbed before any resync, so no twin heals from a sibling's
        undetected corruption."""
        report: dict[str, list[str]] = {}
        to_heal: list[tuple[int, int]] = []
        for s in range(self.n_shards):
            for r, coll in enumerate(self.grid[s]):
                for rdb in coll.rdbs().values():
                    rdb.scrub()
                # runs quarantined at open count too
                bad = [f"{name}/{run}"
                       for name, rdb in coll.rdbs().items()
                       for run in rdb.quarantined]
                if bad:
                    report[f"shard{s}_r{r}"] = bad
                    to_heal.append((s, r))
        for s, r in to_heal:
            self.resync_replica(s, r)
        return report

    def resync_replica(self, shard: int, replica: int) -> bool:
        """Rebuild one twin from a live sibling (``Msg5.h:50`` twin
        correction, and a recovered twin's catch-up); False without a
        healthy source."""
        row = self.grid[shard]
        src = None
        for r, cand in enumerate(row):
            if r != replica and self.hostmap.alive[shard, r]:
                src = cand
                break
        if src is None:
            return False
        dst = row[replica]
        for name, srdb in src.rdbs().items():
            dst.rdbs()[name].replace_with(srdb.get_all())
        dst.num_docs = src.num_docs
        dst._save_stats()
        dst.speller.counts = defaultdict(int, src.speller.counts)
        dst.speller._len_index = None
        dst.titlerec_cache.clear()
        self.mutations += 1
        self.hostmap.mark_alive(shard, replica)
        log.info("resynced shard %d replica %d from a twin", shard,
                 replica)
        return True

    def save(self) -> None:
        for row in self.grid:
            for c in row:
                c.save()


def _default_mesh(sc: ShardedCollection) -> list[torch.device]:
    """The collection's own device for every shard on the CPU; else one
    visible card per shard, wrapped."""
    if sc.device.type == "cpu":
        return make_mesh(sc.n_shards, [sc.device])
    return make_mesh(sc.n_shards)


# ---------------------------------------------------------------------------
# per-shard scoring and the merge
# ---------------------------------------------------------------------------

def _pad_packed(pq: PackedQuery | None, T: int, L: int, D: int,
                plan: QueryPlan, freqw: np.ndarray) -> PackedQuery:
    """One shard's pack padded to the fleet-wide (T, L, D) bucket; None
    becomes an all-invalid block (the empty Msg39 reply)."""
    fl = plan.filters or plan.sortby is not None
    if pq is None:
        required, negative, scored, counts = group_flags(plan, T)
        return PackedQuery(
            doc_idx=np.full((T, L), D, np.int32),
            payload=np.zeros((T, L), np.uint32),
            slot=np.zeros((T, L), np.int32),
            valid=np.zeros((T, L), bool),
            freq_weight=_pad1(freqw, T, 0.5),
            required=required, negative=negative, scored=scored,
            counts=counts, table=pad_table(plan.bool_table),
            cand_docids=np.empty(0, np.uint64),
            siterank=np.zeros(D, np.int32), doclang=np.zeros(D, np.int32),
            n_docs=0, qlang=plan.lang,
            filt=np.zeros(D, bool) if fl else None,
            sortc=np.zeros(D, np.float32) if fl else None)
    t, l = pq.doc_idx.shape
    d = len(pq.siterank)
    doc_idx = np.full((T, L), D, np.int32)
    # this shard's dump row (its own pad index d) re-points at the
    # fleet-wide D
    di = pq.doc_idx.copy()
    di[di >= d] = D
    doc_idx[:t, :l] = di
    payload = np.zeros((T, L), np.uint32)
    payload[:t, :l] = pq.payload
    slot = np.zeros((T, L), np.int32)
    slot[:t, :l] = pq.slot
    valid = np.zeros((T, L), bool)
    valid[:t, :l] = pq.valid
    siterank = np.zeros(D, np.int32)
    siterank[:d] = pq.siterank
    doclang = np.zeros(D, np.int32)
    doclang[:d] = pq.doclang
    filt = sortc = None
    if pq.filt is not None or pq.sortc is not None or fl:
        filt = np.zeros(D, bool)
        sortc = np.zeros(D, np.float32)
        if pq.filt is not None:
            filt[: len(pq.filt)] = pq.filt
        if pq.sortc is not None:
            sortc[: len(pq.sortc)] = pq.sortc
    return PackedQuery(
        doc_idx=doc_idx, payload=payload, slot=slot, valid=valid,
        freq_weight=_pad1(freqw, T, 0.5),
        required=pq.required, negative=pq.negative,
        scored=pq.scored, counts=pq.counts, table=pq.table,
        cand_docids=pq.cand_docids,
        siterank=siterank, doclang=doclang, n_docs=pq.n_docs,
        qlang=pq.qlang, filt=filt, sortc=sortc)


def _global_freq_weights(preps: list[PreparedQuery | None],
                         plan: QueryPlan, num_docs: int) -> np.ndarray:
    """Cluster-wide term-frequency weights: each shard's per-group doc
    counts summed, shards without candidates included (their postings
    still count). A dead shard (None) cannot be counted."""
    counts = sum(p.unique_counts for p in preps if p is not None)
    if isinstance(counts, int):  # every shard down
        counts = np.zeros(len(plan.groups), np.int64)
    return weights.term_freq_weight(counts, max(num_docs, 1))


def _stack_rows(rows: list[PackedQuery]) -> dict[str, np.ndarray]:
    """N padded packs of one (T, L, D) bucket as ``[N, ...]`` arrays."""
    D = len(rows[0].siterank)
    st = lambda f: np.stack([f(p) for p in rows])
    return dict(
        doc_idx=st(lambda p: p.doc_idx),
        payload=st(lambda p: p.payload.view(np.int32)),
        slot=st(lambda p: p.slot), valid=st(lambda p: p.valid),
        freq_weight=st(lambda p: p.freq_weight),
        required=st(lambda p: p.required),
        negative=st(lambda p: p.negative),
        scored=st(lambda p: p.scored), counts=st(lambda p: p.counts),
        table=st(lambda p: p.table), siterank=st(lambda p: p.siterank),
        doclang=st(lambda p: p.doclang),
        qlang=np.asarray([p.qlang for p in rows], np.int32),
        n_docs=np.asarray([p.n_docs for p in rows], np.int32),
        filt=st(lambda p: p.filt if p.filt is not None
                else np.zeros(D, bool)),
        sortc=st(lambda p: p.sortc if p.sortc is not None
                 else np.zeros(D, np.float32)))


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """One host array to ``dev`` without blocking (the mesh's staging)."""
    if jitwatch.g_jitwatch.enabled:
        jitwatch.note_transfer("_upload", "h2d", a.nbytes)
    return torch.from_numpy(a).to(dev, non_blocking=True)


def _score_shards(mesh, per_shard: list[list[PackedQuery]], local_k: int,
                  use_filter: bool, use_sort: bool, extra=None,
                  staged: list | None = None):
    """Score ``per_shard[s]`` (B padded packs of shard s) on shard s's
    device: the shards of one device stack into one ``[S_g·B, ...]``
    cube with one K1 launch. ``extra[s]`` are per-shard ``[B, D]``
    candidate columns gathered at the top-k indices (docids, sitehash)
    with the candidate counts ``[B]``. Returns, on ``mesh[0]``, the
    match counts ``[S, B]``, the top scores ``[S, B, k]`` and the top
    indices (or, with ``extra``, the gathered columns with pad-candidate
    hits scored 0). ``staged``, when given, gets the bytes uploaded."""
    S = len(per_shard)
    B = len(per_shard[0])
    home = mesh[0]
    by_dev: dict = {}
    for s in range(S):
        by_dev.setdefault(mesh[s], []).append(s)
    nm = [None] * S
    ts = [None] * S
    cols = [None] * S
    for dev, shards in by_dev.items():
        a = _stack_rows([p for s in shards for p in per_shard[s]])
        t = {k: _upload(v, dev) for k, v in a.items()}
        if staged is not None:
            staged.append(sum(v.nbytes for v in a.values()))
        with trace.span("mesh.score", rows=len(shards) * B,
                        docs=int(a["siterank"].shape[-1])):
            n_m, top_s, top_i = score_core(
                t["doc_idx"], t["payload"], t["slot"], t["valid"],
                t["freq_weight"], t["required"], t["negative"],
                t["scored"], t["counts"], t["table"], t["siterank"],
                t["doclang"], t["qlang"], t["n_docs"],
                n_positions=MAX_POSITIONS, topk=local_k,
                filt=t["filt"] if use_filter else None,
                sortc=t["sortc"] if use_sort else None)
        if extra is not None:
            docs, shs, ncs = (np.concatenate([extra[s][i] for s in shards])
                              for i in range(3))
            if staged is not None:
                staged.append(docs.nbytes + shs.nbytes + ncs.nbytes)
            docs, shs, ncs = (_upload(x, dev) for x in (docs, shs, ncs))
            # pad-candidate hits (index past the shard's real count)
            top_s = torch.where(top_i < ncs[:, None], top_s, 0.0)
            g = (torch.gather(docs, 1, top_i), torch.gather(shs, 1, top_i))
        else:
            g = (top_i,)
        for j, s in enumerate(shards):
            rows = slice(j * B, (j + 1) * B)
            nm[s] = n_m[rows].to(home)
            ts[s] = top_s[rows].to(home)
            cols[s] = tuple(x[rows].to(home) for x in g)
    return (torch.stack(nm), torch.stack(ts),
            tuple(torch.stack([c[i] for c in cols])
                  for i in range(len(cols[0]))))


def sharded_search(sc: ShardedCollection, q: str | QueryPlan, *,
                   mesh=None, topk: int = 10, lang: int = 0,
                   offset: int = 0, with_snippets: bool = True,
                   site_cluster: bool = True) -> SearchResults:
    """Scatter-gather query over the mesh (the Msg40 → Msg3a → Msg39
    path): each shard's candidates packed on the host, scored in one
    batched cube, the per-shard top-k merged; the merge window grows ×4
    while site clustering leaves the page short (the Msg40 recall loop,
    ``Msg40.cpp:2117``), the scoring kept."""
    plan = q if isinstance(q, QueryPlan) else compile_query(q, lang=lang)
    if mesh is None:
        mesh = _default_mesh(sc)
    # a shard with no alive twin contributes nothing, not even term
    # stats; the answer is flagged degraded
    serving = [sc.hostmap.serving_replica(s) for s in range(sc.n_shards)]
    degraded = any(r is None for r in serving)
    # gbsortby: every shard shifts its keys by the same minimum
    sort_base = None
    if plan.sortby is not None:
        bases = [b for i, c in enumerate(sc.shards)
                 if serving[i] is not None
                 and (b := local_sort_base(c, *plan.sortby)) is not None]
        sort_base = min(bases) if bases else 0.0
    with trace.span("mesh.pack", shards=sc.n_shards):
        preps = [prepare_query(c, plan, sort_base=sort_base)
                 if serving[i] is not None else None
                 for i, c in enumerate(sc.shards)]
        freqw = _global_freq_weights(preps, plan, sc.num_docs)
        packs = [pack_pass(p) if p is not None else None for p in preps]
    live = [p for p in packs if p is not None]
    if not live:
        return SearchResults(query=plan.raw, total_matches=0,
                             degraded=degraded,
                             suggestion=suggest_sharded(sc, plan))
    T = max(p.doc_idx.shape[0] for p in live)
    L = max(p.doc_idx.shape[1] for p in live)
    D = max(len(p.siterank) for p in live)
    packs = [_pad_packed(p, T, L, D, plan, freqw) for p in packs]
    k = min(_bucket(max(topk + offset, 64), 64), D)
    nm, ts, (ti,) = _score_shards(
        mesh, [[p] for p in packs], k, bool(plan.filters),
        plan.sortby is not None)
    total = int(nm.sum())
    flat_sc = ts.reshape(-1)
    flat_ix = ti.reshape(-1)
    want = max(topk + offset, PQR_SCAN)
    out_k = max(want, 64)
    max_out = sc.n_shards * k
    while True:
        kk = min(_bucket(out_k, 64), max_out)
        with trace.span("mesh.merge", window=kk):
            m_sc, m_pos = top_k(flat_sc, kk)
            m_local = flat_ix[m_pos].cpu().numpy()
            m_sc = m_sc.cpu().numpy().copy()
            m_shard = (m_pos // k).cpu().numpy()
        # (owning shard, local candidate) → docid; a pad slot scores 0
        docids = np.zeros(len(m_sc), np.uint64)
        for i, (shard, local) in enumerate(zip(m_shard, m_local)):
            cd = packs[int(shard)].cand_docids
            if int(local) < len(cd):
                docids[i] = cd[int(local)]
            else:
                m_sc[i] = 0.0
        results, clustered = build_results(
            sc.get_document, docids, m_sc, plan, topk=want,
            with_snippets=False, site_cluster=site_cluster)
        if len(results) >= want or clustered == 0 or out_k >= max_out:
            break
        out_k *= 4
    page = finish_page(
        results, offset=offset, topk=topk,
        conf=sc.shards[0].conf, qlang=plan.lang,
        get_doc=sc.get_document,
        langid_of=lambda d: _coll_langid_of(
            sc.shards[int(sc.hostmap.shard_of_docid(d))])(d),
        words=plan.match_words(), with_snippets=with_snippets)
    return SearchResults(
        query=plan.raw, total_matches=total, results=page,
        clustered=clustered, degraded=degraded,
        suggestion=suggest_sharded(sc, plan) if total == 0 else None)


# ---------------------------------------------------------------------------
# the in-program merge: scoring, Msg3a merge and site dedup in one wave
# ---------------------------------------------------------------------------

def _site_cols(coll: Collection):
    """One shard's clusterdb columns (sorted docids, sitehash, langid),
    cached on the clusterdb version: a wave's candidate sitehash columns
    become one searchsorted instead of a point read per candidate."""
    ver = coll.clusterdb.version
    cached = getattr(coll, "_mesh_site_cols", None)
    if cached is not None and cached[0] == ver:
        return cached[1]
    from ..index import clusterdb as cdb
    lst = coll.clusterdb.get_all()
    if len(lst):
        f = cdb.unpack_key(lst.keys)
        order = np.argsort(f["docid"], kind="stable")
        cols = (f["docid"][order].astype(np.uint64),
                f["sitehash"][order].astype(np.uint32),
                f["langid"][order].astype(np.uint32))
    else:
        cols = (np.empty(0, np.uint64), np.empty(0, np.uint32),
                np.empty(0, np.uint32))
    coll._mesh_site_cols = (ver, cols)
    return cols


def _cand_site_cols(coll: Collection, cand: np.ndarray):
    """Candidate docids → (sitehash, langid) uint32 columns. Of several
    clusterdb records of a docid the latest wins; a missing record maps
    to 0 (exempt from site clustering, as on the host walk)."""
    docids, sh, lg = _site_cols(coll)
    out_sh = np.zeros(len(cand), np.uint32)
    out_lg = np.zeros(len(cand), np.uint32)
    if len(docids) and len(cand):
        pos = np.searchsorted(docids, cand, side="right") - 1
        ok = pos >= 0
        ok[ok] = docids[pos[ok]] == cand[ok]
        out_sh[ok] = sh[pos[ok]]
        out_lg[ok] = lg[pos[ok]]
    return out_sh, out_lg


def mesh_generation(sc: ShardedCollection) -> tuple:
    """The mesh serving generation: corpus mutations × the serving twin
    per shard × each serving twin's posdb version. A write, a death or a
    recovery moves it; the ResidentLoop then drains its in-flight waves
    and packs the next from the new serving twins (a killed twin loses no
    query)."""
    serving = sc.hostmap.serving_vector()
    return (sc.mutations, serving,
            tuple(sc.grid[s][r].posdb.version if r is not None else -1
                  for s, r in enumerate(serving)))


#: query-batch bucket floor (a wave pads to the next power of two)
B_FLOOR = 4

#: over-fetch factor c of the recall ladder: the first merge window is
#: k·c, so a page of 2-per-site survivors usually needs no escalation
OVERFETCH_C = 2


@dataclass
class _MeshWave:
    """One sub-wave of a ticket (plans sharing the filter and sort
    statics). ``blocks`` keeps the per-shard top-k blocks on the merge
    device, so the recall escalation re-merges without re-packing or
    re-scoring; only the merge window ``out_k`` grows."""
    out: tuple | None     # the merge's outputs (device tensors)
    blocks: tuple         # (totals [B], then [B, S, k] scores, docids,
    #                       sitehash)
    qidx: list            # plan indices served by this wave
    out_k: int
    max_out: int
    #: merge windows re-run for recall (the ``escalations`` of the
    #: flight recorder's round)
    escalations: int = 0
    #: the wave's ``mesh_stage`` key in the HBM ledger ("" when off)
    stage_key: str = ""


@dataclass
class MeshPending:
    plans: list
    want: int
    waves: list = field(default_factory=list)


class MeshServeIndex:
    """The wave engine behind :meth:`MeshResident.serve_batch`, in the
    ResidentLoop's duck type (``issue_batch`` / ``collect_batch`` /
    ``_built_version``, ``sitehash_of`` / ``langid_of``). The serving
    twin per shard and its posdb version are frozen into
    ``_built_version``; the loop swaps in a fresh index between waves
    when they move."""

    def __init__(self, sc: ShardedCollection, mesh=None):
        self.sc = sc
        self.mesh = mesh if mesh is not None else _default_mesh(sc)
        self._built_version = mesh_generation(sc)
        serving = sc.hostmap.serving_vector()
        #: pack-time read set: the serving twin per shard, None where the
        #: whole shard is down (its block is the empty Msg39 reply)
        self.colls = [sc.grid[s][r] if r is not None else None
                      for s, r in enumerate(serving)]
        self.degraded = any(c is None for c in self.colls)
        self.total_docs = sc.num_docs
        #: merge windows re-run for recall, over this index's waves
        self.escalations = 0
        #: waves scored (one K1 launch per distinct mesh device each)
        self.waves = 0

    # --- host post-processing lookups (Msg20 / Msg51 point reads) ---

    def _home(self, docid: int) -> Collection | None:
        return self.colls[int(self.sc.hostmap.shard_of_docid(docid))]

    def sitehash_of(self, docid: int) -> int:
        c = self._home(docid)
        if c is None:
            return 0
        sh, _ = _cand_site_cols(c, np.asarray([docid], np.uint64))
        return int(sh[0])

    def langid_of(self, docid: int) -> int:
        c = self._home(docid)
        if c is None:
            return 0
        _, lg = _cand_site_cols(c, np.asarray([docid], np.uint64))
        return int(lg[0])

    # --- the issue / collect split the ResidentLoop drives ---

    def issue_batch(self, queries, topk: int = 64, lang: int = 0
                    ) -> MeshPending:
        """Pack the wave on the host, score it and queue the merge;
        nothing waits for the device."""
        plans = [q if isinstance(q, QueryPlan) else
                 compile_query(q, lang=lang) for q in queries]
        want = max(int(topk), 1)
        # sub-waves by the filter and sort statics
        groups: dict[tuple, list[int]] = {}
        for i, plan in enumerate(plans):
            key = (bool(plan.filters), plan.sortby is not None)
            groups.setdefault(key, []).append(i)
        waves = [self._issue_wave([plans[i] for i in qidx], qidx, want,
                                  use_f, use_s)
                 for (use_f, use_s), qidx in groups.items()]
        return MeshPending(plans=plans, want=want, waves=waves)

    def _issue_wave(self, plans, qidx, want, use_f, use_s):
        S = self.sc.n_shards
        with trace.span("mesh.pack", queries=len(plans), shards=S):
            per_q = []      # (packs[s] | None, freqw) per plan
            for plan in plans:
                sort_base = None
                if plan.sortby is not None:
                    bases = [b for c in self.colls if c is not None
                             and (b := local_sort_base(c, *plan.sortby))
                             is not None]
                    sort_base = min(bases) if bases else 0.0
                preps = [prepare_query(c, plan, sort_base=sort_base)
                         if c is not None else None for c in self.colls]
                freqw = _global_freq_weights(preps, plan, self.total_docs)
                per_q.append(([pack_pass(p) if p is not None else None
                               for p in preps], freqw))
            live = [p for packs, _ in per_q for p in packs
                    if p is not None]
            if not live:
                return _MeshWave(out=None, blocks=(), qidx=list(qidx),
                                 out_k=0, max_out=0)
            # fleet-wide buckets across the wave: rectangular [S, B, ...]
            T = max(p.doc_idx.shape[0] for p in live)
            L = max(p.doc_idx.shape[1] for p in live)
            D = max(len(p.siterank) for p in live)
            local_k = min(_bucket(max(want, 64), 64), D)
            B = _bucket(max(len(plans), 1), B_FLOOR)
            rows = [[_pad_packed(p, T, L, D, plan, freqw) for p in packs]
                    for (packs, freqw), plan in zip(per_q, plans)]
            while len(rows) < B:    # pad the batch with empty queries
                rows.append([_pad_packed(None, T, L, D, plans[0],
                                         per_q[0][1]) for _ in range(S)])
            extra = []
            for s in range(S):
                docs = np.zeros((B, D), np.int64)
                shs = np.zeros((B, D), np.int64)
                ncs = np.zeros(B, np.int64)
                for b, packs in enumerate(rows):
                    cand = packs[s].cand_docids
                    d = len(cand)
                    if d and self.colls[s] is not None:
                        docs[b, :d] = cand.astype(np.int64)
                        shs[b, :d] = _cand_site_cols(self.colls[s],
                                                     cand)[0]
                    ncs[b] = d
                extra.append((docs, shs, ncs))
        staged: list = []
        nm, ts, (g_doc, g_sh) = _score_shards(
            self.mesh, [[packs[s] for packs in rows] for s in range(S)],
            local_k, use_f, use_s, extra=extra, staged=staged)
        self.waves += 1
        max_out = S * local_k
        out_k = min(_bucket(max(OVERFETCH_C * want, 64), 64), max_out)
        # [S, B, k] → the merge's [B, S, k]
        blocks = (nm.sum(dim=0), ts.transpose(0, 1).contiguous(),
                  g_doc.transpose(0, 1).contiguous(),
                  g_sh.transpose(0, 1).contiguous())
        wave = _MeshWave(out=None, blocks=blocks, qidx=list(qidx),
                         out_k=out_k, max_out=max_out)
        if devwatch.enabled():
            # the staged operands live on the card from issue until the
            # collect drops the slot (keys cycle mod 8: in-flight waves
            # never exceed the loop's depth)
            self._stage_seq = getattr(self, "_stage_seq", 0) + 1
            wave.stage_key = f"wave{self._stage_seq % 8}"
            devwatch.note_buffer(self.sc.name, "mesh_stage",
                                 wave.stage_key, int(sum(staged)))
        wave.out = self._merge(wave)
        return wave

    def _merge(self, wave: _MeshWave):
        _, g_sc, g_doc, g_sh = wave.blocks
        with trace.span("mesh.merge", window=wave.out_k):
            return merge_dedup_topk(g_sc, g_doc, g_sh, wave.out_k,
                                    max_per_site=MAX_PER_SITE)

    def collect_batch(self, pending: MeshPending):
        """Fetch each wave's merged block; while a query's survivors fall
        short of ``want`` with its whole window live, re-merge with a ×4
        window from the same per-shard blocks (the in-program Msg40
        recall loop).

        Returns per plan ``(docids, scores, total_matches, clustered,
        sitehash)``: survivors only, already site-deduped."""
        want = pending.want
        results: list = [None] * len(pending.plans)
        empty = (np.empty(0, np.uint64), np.empty(0, np.float32), 0, 0,
                 np.empty(0, np.uint32))
        for wave in pending.waves:
            if wave.out is None:        # every shard down
                for qi in wave.qidx:
                    results[qi] = empty
                continue
            device_s = 0.0
            while True:
                t_fetch = time.perf_counter()
                n_kept, n_drop = (x.cpu().numpy() for x in wave.out[:2])
                device_s += time.perf_counter() - t_fetch
                K = wave.out_k
                need_more = any(
                    n_kept[b] < want and n_kept[b] + n_drop[b] >= K
                    for b in range(len(wave.qidx)))
                if not need_more or K >= wave.max_out:
                    break
                wave.out_k = min(_bucket(wave.out_k * 4, 64),
                                 wave.max_out)
                wave.out = self._merge(wave)
                wave.escalations += 1
                self.escalations += 1
            total = wave.blocks[0].cpu().numpy()
            docids, shs, scs, cum = (x.cpu().numpy() for x in wave.out[2:])
            if devwatch.enabled():
                devwatch.note_round(
                    coll=self.sc.name, kinds="mesh", waves=1,
                    device_s=device_s,
                    bytes_out=int(sum(x.nbytes for x in (
                        n_kept, n_drop, docids, shs, scs, cum))),
                    out_k=wave.out_k, escalations=wave.escalations)
                if wave.stage_key:
                    devwatch.drop_buffer(self.sc.name, "mesh_stage",
                                         wave.stage_key)
            for b, qi in enumerate(wave.qidx):
                nk, nd = int(n_kept[b]), int(n_drop[b])
                # the greedy walk's clustered counter at the page cut:
                # cumdrop is exclusive, so survivor want-1 carries the
                # drops counted before the walk's want-th accept
                clustered = nd if nk < want else int(cum[b, want - 1])
                results[qi] = (docids[b, :nk].astype(np.uint64),
                               scs[b, :nk].astype(np.float32),
                               int(total[b]), clustered,
                               shs[b, :nk].astype(np.uint32))
        return results


class MeshResident:
    """One resident :class:`~..query.devindex.DeviceIndex` per shard, each
    on its shard's device (``devices``: one per shard, wrapped; default
    the visible cards, or the collection's CPU device).

    * ``search_batch``, the host merge: each shard routes each query
      (F1, F2 or FD) by its own runs and runs its own lossless ladder,
      with cluster-wide dfs, doc count and sort base; the tiny per-shard
      replies merge in numpy (the Msg39 boundary, ``Msg39.cpp:74``).
    * ``serve_batch``, the in-program merge: one :class:`MeshServeIndex`
      wave per ticket under a ResidentLoop, with the Msg3a merge, the
      2-per-site dedup and the recall over-fetch before anything
      reaches the host.
    """

    def __init__(self, sc: ShardedCollection, devices=None):
        self.sc = sc
        if devices is None:
            devices = _default_mesh(sc)
        self.devices = make_mesh(sc.n_shards, devices)
        self.indexes = [build_device_index(sc.shards[s],
                                           device=self.devices[s])
                        for s in range(sc.n_shards)]
        self._pool: ThreadPoolExecutor | None = None
        # cluster-wide df memo: termid → df, valid while every shard's
        # resident base stays at the generation it was filled under
        self._df_memo: dict[int, int] = {}
        self._df_memo_gen = None
        self._serve_idx: MeshServeIndex | None = None
        self._serve_loop = None

    def refresh(self) -> None:
        for di in self.indexes:
            di.refresh()

    def _global_df(self, termid: int) -> int:
        """Cluster-wide document frequency, memoized per resident-base
        generation tuple: a hot word pays the S per-shard walks once per
        corpus generation, not once per plan."""
        gen = tuple(di.df_generation for di in self.indexes)
        if gen != self._df_memo_gen:
            self._df_memo.clear()
            self._df_memo_gen = gen
        df = self._df_memo.get(termid)
        if df is None:
            df = sum(di._df_of(termid) for di in self.indexes)
            self._df_memo[termid] = df
        return df

    def _global_sort_base(self, fld: str, desc: bool) -> float:
        bases = [b for di in self.indexes
                 if (b := di.sort_base_of(fld, desc)) is not None]
        return min(bases) if bases else 0.0

    def search_batch(self, queries, topk: int = 10, lang: int = 0,
                     offset: int = 0, with_snippets: bool = True,
                     site_cluster: bool = True) -> list[SearchResults]:
        """B queries × S shards: the shards' resident waves, then the
        Msg3a merge and the Msg40 tail per query."""
        sc = self.sc
        plans = [q if isinstance(q, QueryPlan) else
                 compile_query(q, lang=lang) for q in queries]
        total_docs = sc.num_docs
        want = max(topk + offset, PQR_SCAN)
        k_shard = max(want * 2, 64)

        def run_shard(di):
            return di.search_batch(
                plans, topk=k_shard, lang=lang,
                df_of=self._global_df, total_docs=total_docs,
                sort_base_of=self._global_sort_base)

        if self._pool is None:
            self._pool = ThreadPoolExecutor(max(sc.n_shards, 1))
        per_shard = list(self._pool.map(run_shard, self.indexes))

        def sitehashes_of(docids):
            docids = np.asarray(docids, np.uint64)
            home = sc.hostmap.shard_of_docid(docids)
            out = np.zeros(len(docids), np.int64)
            for s in np.unique(home):
                at = home == s
                out[at] = self.indexes[int(s)].sitehashes_of(docids[at])
            return out

        out = []
        for qi, plan in enumerate(plans):
            docids = np.concatenate(
                [per_shard[s][qi][0] for s in range(sc.n_shards)])
            scores = np.concatenate(
                [per_shard[s][qi][1] for s in range(sc.n_shards)])
            total = sum(int(per_shard[s][qi][2])
                        for s in range(sc.n_shards))
            order = np.argsort(-scores, kind="stable")
            results, clustered = build_results(
                sc.get_document, docids[order], scores[order], plan,
                topk=want, with_snippets=False,
                site_cluster=site_cluster,
                sitehashes=sitehashes_of(docids[order]))
            page = finish_page(
                results, offset=offset, topk=topk,
                conf=sc.shards[0].conf, qlang=plan.lang,
                langid_of=lambda d: self.indexes[
                    int(sc.hostmap.shard_of_docid(d))].langid_of(d),
                get_doc=sc.get_document, words=plan.match_words(),
                with_snippets=with_snippets)
            out.append(SearchResults(
                query=plan.raw, total_matches=total, results=page,
                clustered=clustered,
                suggestion=suggest_sharded(sc, plan)
                if total == 0 else None,
                facets=compute_facets(plan, docids[order],
                                      sc.get_document)))
        return out

    def search(self, q, **kw) -> SearchResults:
        return self.search_batch([q], **kw)[0]

    # --- the in-program merge under a ResidentLoop ---

    def _serve_index(self) -> MeshServeIndex:
        """The MeshServeIndex of the current mesh generation (the loop's
        ``di_fn``)."""
        idx = self._serve_idx
        if idx is None or idx._built_version != mesh_generation(self.sc):
            idx = MeshServeIndex(self.sc, mesh=self.devices)
            self._serve_idx = idx
        return idx

    def serve_loop(self):
        """The mesh ResidentLoop, spawned at first use (and again after a
        stop)."""
        loop = self._serve_loop
        if loop is not None and loop.alive:
            return loop
        loop = spawn_resident_loop(
            self._serve_index, gen_fn=lambda: mesh_generation(self.sc),
            name=f"mesh-{self.sc.name}")
        self._serve_loop = loop
        return loop

    def serve_batch(self, queries, topk: int = 10, lang: int = 0,
                    offset: int = 0, with_snippets: bool = True,
                    site_cluster: bool = True,
                    results_lock=None) -> list[SearchResults]:
        """One ticket through the mesh loop: merged, site-deduped
        survivors come back, and only the Msg40 tail (summaries, PQR,
        facets) runs on the host, under ``results_lock`` when given.
        ``site_cluster=False`` has no in-program variant and takes the
        host merge."""
        if not site_cluster:
            return self.search_batch(queries, topk=topk, lang=lang,
                                     offset=offset,
                                     with_snippets=with_snippets,
                                     site_cluster=False)
        sc = self.sc
        plans = [q if isinstance(q, QueryPlan) else
                 compile_query(q, lang=lang) for q in queries]
        want = max(topk + offset, PQR_SCAN)
        ticket = self.serve_loop().submit(plans, topk=want, lang=lang)
        raw = ticket.wait()
        msi = ticket.di     # the index the wave ran against
        out = []
        lock_ctx = results_lock if results_lock is not None \
            else contextlib.nullcontext()
        with lock_ctx:
            for plan, (docids, scores, total, clustered, shash) in \
                    zip(plans, raw):
                # survivors hold at most MAX_PER_SITE per site already;
                # the host walk counts only what the merge cannot see
                # (content-hash dedup freeing a site's slot)
                results, host_cl = build_results(
                    sc.get_document, docids, scores, plan, topk=want,
                    with_snippets=False, site_cluster=True,
                    sitehashes=shash)
                page = finish_page(
                    results, offset=offset, topk=topk,
                    conf=sc.shards[0].conf, qlang=plan.lang,
                    langid_of=msi.langid_of, get_doc=sc.get_document,
                    words=plan.match_words(),
                    with_snippets=with_snippets)
                out.append(SearchResults(
                    query=plan.raw, total_matches=total, results=page,
                    clustered=clustered + host_cl,
                    degraded=msi.degraded,
                    suggestion=suggest_sharded(sc, plan)
                    if total == 0 else None,
                    facets=compute_facets(plan, docids,
                                          sc.get_document)))
        return out

    def serve(self, q, **kw) -> SearchResults:
        return self.serve_batch([q], **kw)[0]

    def stop(self) -> None:
        """Stop the serving loop and the shard pool (server shutdown);
        both start again at the next search."""
        if self._serve_loop is not None:
            self._serve_loop.stop()
            self._serve_loop.join(timeout=60)
            self._serve_loop = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def suggest_sharded(sc: ShardedCollection, plan: QueryPlan) -> str | None:
    """Cluster-wide "did you mean": the serving twins' dictionaries
    merged, so a word common on one shard is not taken for a typo;
    cached per (mutations, serving topology)."""
    from ..query.speller import merged
    words = [g.display for g in plan.scored_groups
             if " " not in g.display and ":" not in g.display]
    if not words:
        return None
    serving = [(s, r) for s in range(sc.n_shards)
               if (r := sc.hostmap.serving_replica(s)) is not None]
    if not serving:
        return None
    live = [sc.grid[s][r].speller for s, r in serving]
    key = (sc.mutations, tuple(serving))
    cached = getattr(sc, "_merged_speller", None)
    if cached is None or cached[0] != key:
        cached = (key, merged(live))
        sc._merged_speller = cached
    return cached[1].suggest_query(words)
