"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package (the cluster's verbs and modules run with both made
unimportable), and it never quietly runs on the CPU.

The import check runs in a subprocess: this session's conftest has
already imported jax."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from open_source_search_engine_tpu_torch.device import resolve_device
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query.devindex import DeviceIndex

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "open_source_search_engine_tpu_torch"

_PROBE = """
import sys, tempfile
sys.path.insert(0, {root!r})
from open_source_search_engine_tpu_torch.__main__ import main
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.build import devbuild
from open_source_search_engine_tpu_torch.query import (
    devindex, engine, fd_scores_kernel, resident)
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import (
    chaos, deadline, lockcheck, membudget, priority, stats, threads)
c = Collection("iso", tempfile.mkdtemp(), device="cpu")
docproc.index_document(c, "http://a.test/x",
                       "<html><title>alpha</title><p>alpha beta.</p></html>")
res = engine.search(c, "alpha beta", topk=5)
assert res.total_matches == 1, res
res = engine.search_device(c, "alpha beta", topk=5)
assert res.total_matches == 1, res
c.dump_all()
assert devindex.DeviceIndex(c).device.type == "cpu"
assert stats.g_stats.counters["build.device_base"] >= 1
res = engine.search_device_batch(c, ["alpha beta"], topk=5, resident=True)
assert res[0].total_matches == 1, res
g_residency.reset()
from open_source_search_engine_tpu_torch.cache import g_cacheplane
from open_source_search_engine_tpu_torch.query import devcheck, speller
from open_source_search_engine_tpu_torch.serve.server import (
    SearchHTTPServer)
srv = SearchHTTPServer(tempfile.mkdtemp(), port=0, device="cpu")
docproc.index_document(srv.colldb.get("main"), "http://b.test/y",
                       "<html><title>gamma</title><p>gamma delta.</p></html>")
code, body, _ = srv.handle("GET", "/search", dict(q="gamma"), b"")
assert code == 200 and '"totalMatches": 1' in body, body
srv.stop()
g_residency.reset()
from open_source_search_engine_tpu_torch.index import catdb, fielddb, tagdb
from open_source_search_engine_tpu_torch.spider import linkdb
d = Collection("rec", tempfile.mkdtemp(), device="cpu")
d.tagdb.set_tag("ban.test", tagdb.TAG_MANUAL_BAN, 1)
d.catdb.load_tree(chr(9).join(["1", "0", "Top"]))
d.catdb.assign("b.test", 1)
assert docproc.index_document(d, "http://ban.test/", "<p>x</p>") is None
docproc.index_document(d, "http://b.test/y", '<p><a href="http://c.test/">'
                       'anchor words</a> epsilon</p>')
docproc.index_document(d, "http://c.test/", "<p>epsilon zeta</p>")
assert d.linkdb.inlinks_for_url("c.test", "http://c.test/") == [
    ("anchor words", 0)]
assert len(d.fielddb.column(fielddb.DATE_FIELD)[0]) == 2
for q in ("anchor gbmin:catid:0", "epsilon gbsortby:date",
          "epsilon gbmin:catid:1 gbmax:catid:1"):
    assert (engine.search(d, q).total_matches
            == engine.search_device(d, q).total_matches), q
assert engine.search_device(d, "epsilon gbmin:catid:1 gbmax:catid:1"
                            ).total_matches == 1
assert linkdb.site_rank(3) == 3 and catdb.Catdb
from open_source_search_engine_tpu_torch.control import Process
from open_source_search_engine_tpu_torch.control import dailymerge, rebalance
j = tempfile.mkdtemp()
e = Collection("jr", j, device="cpu")
docproc.index_document(e, "http://j.test/", "<p>journal replay words</p>")
del e   # no save, no dump: the reopen replays the journal
e = Collection("jr", j, device="cpu")
assert e.num_docs == 1 and len(e.posdb.mem) and not e.posdb.runs
assert engine.search(e, "journal replay").total_matches == 1
proc = Process()
proc.register(e)
proc.save_all()
assert rebalance.repair(e) == 1 and dailymerge.parse_window("2-5")
from open_source_search_engine_tpu_torch.parallel import (
    MeshResident, ShardedCollection, make_mesh, sharded_search)
sc = ShardedCollection("mesh", tempfile.mkdtemp(), n_shards=2, device="cpu")
for i in range(6):
    sc.index_document(f"http://m{{i}}.test/p", f"<p>mesh words {{i}}</p>")
res = sharded_search(sc, "mesh words", mesh=make_mesh(2, ["cpu"]), topk=5)
assert res.total_matches == 6 and len(res.results) == 5, res
mr = MeshResident(sc, devices=["cpu"])
assert mr.serve("mesh words", topk=5).total_matches == 6
mr.stop()
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "open_source_search_engine_tpu"
       or m.startswith("open_source_search_engine_tpu.")]
assert not bad, bad
print("ISOLATED")
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


_CLI_PROBE = """
import runpy, sys
sys.path.insert(0, {root!r})
sys.argv = ["open_source_search_engine_tpu_torch", "serve", "--help"]
try:
    runpy.run_module("open_source_search_engine_tpu_torch",
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
import open_source_search_engine_tpu_torch.serve.server
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "open_source_search_engine_tpu"
       or m.startswith("open_source_search_engine_tpu.")]
assert not bad, bad
print("ISOLATED")
"""


def test_serve_cli_help_imports_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _CLI_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env(),
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout and "--torch-device" in out.stdout


_CLUSTER_PROBE = """
import importlib.abc, runpy, sys
sys.path.insert(0, {root!r})


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "open_source_search_engine_tpu"):
            raise ImportError(f"{{name}} is blocked in this probe")
        return None


sys.meta_path.insert(0, NoJax())
sys.argv = ["open_source_search_engine_tpu_torch", {verb!r}, "--help"]
try:
    runpy.run_module("open_source_search_engine_tpu_torch",
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from open_source_search_engine_tpu_torch.parallel import (
    cluster, fleet, transport)
from open_source_search_engine_tpu_torch.control.process import (
    Heartbeat, make_rpc_probe)
frame = transport.encode_bin({{"a": __import__("numpy").arange(3)}})
assert transport.decode_bin(frame)["a"].tolist() == [0, 1, 2]
assert fleet.PKG == "open_source_search_engine_tpu_torch"
assert cluster.HostsConf.parse("127.0.0.1:1").n_shards == 1
print("ISOLATED")
"""


@pytest.mark.parametrize("verb", ["node", "proxy"])
def test_cluster_cli_help_runs_with_no_jax_importable(tmp_path, verb):
    out = subprocess.run(
        [sys.executable, "-c",
         _CLUSTER_PROBE.format(root=str(ROOT), verb=verb)],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env(),
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout and "--hosts" in out.stdout
    if verb == "node":
        assert "--torch-device" in out.stdout and "--device" in out.stdout


def test_port_imports_no_jax_in_a_fresh_process(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=_clean_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/torch_sched_scenarios.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib",
                               "open_source_search_engine_tpu"), (path, n)


_NATIVE_PROBE = """
import importlib.abc, sys, tempfile
sys.path.insert(0, {root!r})


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "open_source_search_engine_tpu"):
            raise ImportError(f"{{name}} is blocked in this probe")
        return None


sys.meta_path.insert(0, NoJax())
from open_source_search_engine_tpu_torch import native
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.index.collection import Collection
from open_source_search_engine_tpu_torch.query import engine
c = Collection("nat", tempfile.mkdtemp(), device="cpu")
ml = docproc.index_document(c, "http://n.test/", "<p>native alpha.</p>")
assert native.get_doccore() is not None and native.available()
c.dump_all()
docproc.index_document(c, "http://m.test/", "<p>native beta.</p>")
c.dump_all()
c.posdb.attempt_merge(force=True)
assert engine.search(c, "native").total_matches == 2
maps = open("/proc/self/maps").read()
libs = sorted({{line.split()[-1] for line in maps.splitlines()
                if "libdoccore" in line or "librdbcore" in line}})
print("LIBS", *libs)
"""


def test_native_loads_only_the_ports_own_libraries(tmp_path):
    """The native core imports nothing of the JAX package and loads none
    of its libraries (that package keeps its own beside its sources):
    the two libraries mapped are the port's, built from the port's own
    sources into the ignored build directory."""
    from open_source_search_engine_tpu_torch import native
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env(),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    (line,) = [ln for ln in out.stdout.splitlines()
               if ln.startswith("LIBS")]
    libs = line.split()[1:]
    assert libs == sorted([str(native.library_path("doccore", "-O2")),
                           str(native.library_path("rdbcore", "-O3"))])
    for lib in libs:
        assert Path(lib).parent == ROOT / "build" / "torch_native"
    assert native.SRC_DIR == PORT / "native"
    assert sorted(p.name for p in native.SRC_DIR.glob("*.cpp")) == [
        "doccore.cpp", "rdbcore.cpp"]


def test_sched_scenarios_import_no_jax(tmp_path):
    """``tests/torch_sched_scenarios.py`` drives the port alone: it
    imports, and its scenarios run, with JAX and the JAX package
    unimportable."""
    probe = _NATIVE_PROBE.split("sys.meta_path.insert(0, NoJax())")[0] + (
        "sys.meta_path.insert(0, NoJax())\n"
        "from open_source_search_engine_tpu_torch.utils import schedcheck\n"
        "schedcheck.ENABLED = True\n"
        "from tests import torch_sched_scenarios as s\n"
        "for name, fn in sorted(s.SCENARIOS.items()):\n"
        "    schedcheck.explore(fn, schedules=2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'open_source_search_engine_tpu')]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    out = subprocess.run(
        [sys.executable, "-c", probe.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env(),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Collection("nocuda", tmp_path)
    assert not (tmp_path / "coll").exists()
    cpu = Collection("cpu", tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex(cpu, device="cuda")


def test_cli_default_device_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    page = tmp_path / "p.html"
    page.write_text("<p>alpha</p>")
    out = subprocess.run(
        [sys.executable, "-m", "open_source_search_engine_tpu_torch",
         "inject", "--dir", str(tmp_path / "d"), "http://a.test/", str(page)],
        capture_output=True, text=True, cwd=ROOT, env=_clean_env(),
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=_clean_env(), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_TELEMETRY_PROBE = """
import importlib.abc, json, sys, tempfile
sys.path.insert(0, {root!r})


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "open_source_search_engine_tpu"):
            raise ImportError(f"{{name}} is blocked in this probe")
        return None


sys.meta_path.insert(0, NoJax())
from open_source_search_engine_tpu_torch.build import docproc
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.utils import (
    chaos, devdoctor, devwatch, jitwatch, lockcheck, profiler)
assert devwatch.enabled() and jitwatch.enabled() and lockcheck.ENABLED
srv = SearchHTTPServer(tempfile.mkdtemp(), port=0, device="cpu")
c = srv.colldb.get("main")
docproc.index_document(c, "http://t.test/", "<p>telemetry words</p>")
srv.start()
assert srv.handle("GET", "/search", dict(q="telemetry"), b"")[0] == 200
for path in ("/admin/hbm", "/admin/device", "/admin/jit",
             "/admin/profiler", "/admin/graph"):
    assert srv.handle("GET", path, {{}}, b"")[0] == 200, path
assert devwatch.snapshot()["totals"]["waves"] >= 1
assert jitwatch.snapshot()["totals"]["transfers"] >= 1
assert devdoctor.probe()["status"] == "no-accelerator"
srv.stop()
g_residency.reset()
assert lockcheck.g_lockcheck.report()["cycles"] == []
print("ISOLATED")
"""


def test_telemetry_planes_run_with_no_jax_importable(tmp_path):
    env = _clean_env()
    env.update(OSSE_DEVWATCH="1", OSSE_JITWATCH="1", OSSE_LOCKCHECK="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run(
        [sys.executable, "-c", _TELEMETRY_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout


_CRAWL_PROBE = """
import importlib.abc, json, runpy, sys, tempfile, time
sys.path.insert(0, {root!r})


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "open_source_search_engine_tpu"):
            raise ImportError(f"{{name}} is blocked in this probe")
        return None


sys.meta_path.insert(0, NoJax())
for verb in ("crawl", "serve"):
    sys.argv = ["open_source_search_engine_tpu_torch", verb, "--help"]
    try:
        runpy.run_module("open_source_search_engine_tpu_torch",
                         run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
from open_source_search_engine_tpu_torch import spider
from open_source_search_engine_tpu_torch.build import convert
from open_source_search_engine_tpu_torch.serve import crawlbot
from open_source_search_engine_tpu_torch.serve.server import SearchHTTPServer
from open_source_search_engine_tpu_torch.serve.tenancy import g_residency
from open_source_search_engine_tpu_torch.spider import (
    fetcher, loop, proxies, scheduler, spiderdb)
from open_source_search_engine_tpu_torch.utils import (
    dnsresolver, ipresolve, ttlcache, unicodenorm)
assert dnsresolver.parse_response(dnsresolver.build_query("a.test", 7))[
    "id"] == 7
assert ipresolve._pseudo_ip("a.test").startswith("0.")
assert unicodenorm.resolve_charset("x-sjis") == "shift_jis"
assert ttlcache.TtlCache().get("k") is None
assert convert.pdf_text_builtin(
    b"<< >>stream\\nBT (probe text) Tj ET\\nendstream") == "probe text"
assert not proxies.ProxyPool([]) and proxies.looks_banned(403, "")
pages = {{"http://p.test/": '<p>probe words <a href="/b">b</a></p>',
         "http://p.test/b": "<p>probe beta</p>"}}


class Fake(fetcher.Fetcher):
    def fetch_many(self, urls):
        return [fetcher.FetchResult(url=u, status=200, content=pages[u],
                                    content_type="text/html") for u in urls]


srv = SearchHTTPServer(tempfile.mkdtemp(), port=0, device="cpu")
srv.crawl_fetcher_factory = Fake
code, body, _ = srv.handle("GET", "/crawlbot", dict(
    name="iso", seeds="http://p.test/", maxpages="5"), b"")
assert code == 200, body
deadline = time.monotonic() + 60
while not json.loads(srv.handle("GET", "/crawlbot", dict(name="iso"),
                                b"")[1])["done"]:
    assert time.monotonic() < deadline
    time.sleep(0.05)
code, body, _ = srv.handle("GET", "/search", dict(q="probe", c="crawl_iso"),
                           b"")
assert code == 200 and '"totalMatches": 2' in body, body
assert srv.handle("GET", "/crawlbot", dict(name="iso", action="delete"),
                  b"")[0] == 200
srv.stop()
g_residency.reset()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "open_source_search_engine_tpu")]
assert not bad, bad
print("ISOLATED")
"""


def test_crawl_plane_runs_with_no_jax_importable(tmp_path):
    """Every module of the crawl plane imports, and a crawlbot job runs
    and is searched and deleted, with JAX and the JAX package
    unimportable; the ``crawl`` verb's and ``serve --spider``'s help
    print."""
    out = subprocess.run(
        [sys.executable, "-c", _CRAWL_PROBE.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env(),
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout
    assert "--seeds" in out.stdout and "--max-pages" in out.stdout
    assert "--spider" in out.stdout


_DOCTOR_PROBE = """
import importlib.abc, runpy, sys
sys.path.insert(0, {root!r})


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "open_source_search_engine_tpu"):
            raise ImportError(f"{{name}} is blocked in this probe")
        return None


sys.meta_path.insert(0, NoJax())
sys.argv = ["devdoctor"] + {args!r}
runpy.run_module("open_source_search_engine_tpu_torch.utils.devdoctor",
                 run_name="__main__")
"""


@pytest.mark.parametrize("visible,args,rc,verdict", [
    (None, [], 2, "no-accelerator"),
    ("0", [], 1, "fallback"),
    (None, ["--expect-card"], 1, "fallback"),
])
def test_devdoctor_verdicts_without_a_card(tmp_path, visible, args, rc,
                                           verdict):
    """``python -m ...utils.devdoctor`` with no jax importable: no card
    and none expected is ``no-accelerator`` (exit 2); a card named by
    ``CUDA_VISIBLE_DEVICES`` or by the caller is ``fallback`` (exit 1)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = _clean_env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    out = subprocess.run(
        [sys.executable, "-c",
         _DOCTOR_PROBE.format(root=str(ROOT), args=args)],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == rc, (out.returncode, out.stderr[-2000:])
    rec = json.loads(out.stdout)
    assert rec["status"] == verdict and rec["cuda_available"] is False
    assert rec["card_expected"] is (verdict == "fallback")


def test_devdoctor_module_entry_point(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = _clean_env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run(
        [sys.executable, "-m",
         "open_source_search_engine_tpu_torch.utils.devdoctor"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 2 and '"no-accelerator"' in out.stdout
