"""meshcheck over the port: ``tests/test_analysis.py``'s cases, run against
``radixmesh_tpu_torch.analysis`` over ``radixmesh_tpu_torch/`` (the gate, the
shared positive controls, the suppression grammar, the live grep-invisible
and concurrency cases, the CLI's pinned exit codes through ``python -m
radixmesh_tpu_torch.meshcheck``), then the port's own cases: its fixture
trees (the torch device-sync vocabulary and the module-alias call edge),
which the JAX package's checkers cannot see, the declared thread roots the
port adds, and the lock that ``KVTransferPlane.bind`` publishes under."""

import ast
from pathlib import Path

from _torch_twin import load_twin

load_twin(
    "test_analysis",
    globals(),
    subs=(
        ('str(_REPO / "scripts" / "meshcheck.py")', '"-m", "radixmesh_tpu_torch.meshcheck"'),
        ("capture_output=True, text=True, timeout=120,",
         "capture_output=True, text=True, timeout=120, cwd=_REPO,"),
    ),
)

_PORT_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis_torch"


def _hits(controls, fixture):
    return sorted((c.invariant, c.file, c.line, c.tripped) for c in controls if c.fixture == fixture)


def test_port_controls_trip(controls):
    """The torch syncs and the host copies of pool gathers in ``Engine.step``,
    and the sleeps reached only through modules imported by name."""
    sync = _hits(controls, "torch_device_sync")
    assert [h[2] for h in sync if h[0] == "hotpath-sync"] == [15, 16, 17, 18, 19, 20]
    assert [h[2] for h in sync if h[0] == "hotpath-blocking"] == [15, 16, 17]
    assert _hits(controls, "plain_import_edge") == [
        ("hotpath-blocking", "utils/drain.py", 5, True),
        ("hotpath-blocking", "utils/pacing.py", 5, True),
    ]
    assert all(h[3] for h in sync)


def test_port_controls_are_invisible_to_the_jax_checkers():
    """The port's controls prove the port's rewrites: the JAX package's
    checkers, run over the same trees, see only the ``np.asarray`` of a pool
    gather (the one construct both vocabularies share)."""
    from radixmesh_tpu.analysis.controls import run_positive_controls as jax_controls

    seen = [(c.fixture, c.invariant, c.file, c.line) for c in jax_controls(_PORT_FIXTURES) if c.tripped]
    assert seen == [("torch_device_sync", "hotpath-sync", "engine/engine.py", 20)]


def test_sampled_token_reads_stay_legal():
    """A step's read of its sampled tokens is not KV: quiet in the fixture,
    and the engine's own ``.cpu().numpy()`` reads raise nothing, even before
    suppression."""
    from radixmesh_tpu_torch.analysis import all_checkers, check_tree, tree_index
    from radixmesh_tpu_torch.analysis.core import SourceIndex, run_checkers

    fixture = run_checkers(SourceIndex(_PORT_FIXTURES / "torch_device_sync"), all_checkers(), flag_stale=False)
    assert not [f for f in fixture.findings if f.line == 21], fixture.pretty()
    src = tree_index().module("engine/engine.py").source
    assert src.count(".cpu().numpy()") >= 4
    raw = [f for f in check_tree().raw_by_checker["hot-path"]
           if f.file == "engine/engine.py" and f.invariant == "hotpath-sync"]
    assert not raw, "\n".join(map(str, raw))


def test_module_alias_calls_are_call_edges():
    """``import radixmesh_tpu_torch.cache.oplog as oplog_mod`` in
    ``workload.py``: the calls through the alias are edges, and a change to
    the module widens ``--changed`` to its importer."""
    from radixmesh_tpu_torch.analysis import changed_scope, tree_index
    from radixmesh_tpu_torch.analysis.callgraph import get_callgraph

    cg = get_callgraph(tree_index())
    assert cg.module_aliases["workload.py"]["oplog_mod"] == "cache/oplog.py"
    assert ("cache/oplog.py", "serialize") in cg.edges[("workload.py", "run_obs_workload")]
    assert "workload.py" in changed_scope(tree_index(), ["cache/oplog.py"])


def test_jax_package_imports_are_not_this_package(tmp_path):
    """The package name is matched exactly: ``radixmesh_tpu`` is another
    package, so its imports resolve to nothing here."""
    from radixmesh_tpu_torch.analysis.callgraph import CallGraph
    from radixmesh_tpu_torch.analysis.core import SourceIndex

    (tmp_path / "cache").mkdir()
    (tmp_path / "cache" / "oplog.py").write_text("def serialize():\n    return 1\n")
    (tmp_path / "top.py").write_text(
        "import radixmesh_tpu.cache.oplog as jax_oplog\n"
        "from radixmesh_tpu.cache.oplog import serialize as jax_serialize\n"
        "import radixmesh_tpu_torch.cache.oplog as oplog\n\n"
        "def f():\n    jax_oplog.serialize()\n    jax_serialize()\n\n"
        "def g():\n    oplog.serialize()\n"
    )
    cg = CallGraph(SourceIndex(tmp_path))
    assert cg.imports["top.py"] == {"oplog": "cache/oplog.py"}
    assert cg.edges[("top.py", "f")] == set()
    assert cg.edges[("top.py", "g")] == {("cache/oplog.py", "serialize")}


def test_port_declared_roots_resolve():
    """The seams the port adds are declared roots of the thread map: the
    pool proxy's frees from a mesh replica's threads, and the KV plane's
    handoff lane."""
    from radixmesh_tpu_torch.analysis import get_thread_map, tree_index
    from radixmesh_tpu_torch.analysis.thread_roots import DECLARED_ROOTS

    declared = {name: (rel, qual, multi) for rel, qual, name, multi in DECLARED_ROOTS}
    assert declared["mesh-pool-free"] == ("parallel/step_sync.py", "MeshPoolProxy.free", True)
    assert declared["kv-handoff-lane"] == ("engine/disagg.py", "PrefillWorker.prefill_handoff_stream", False)
    roots = {r.name: r for r in get_thread_map(tree_index()).roots}
    assert roots["mesh-pool-free"].kind == "declared" and roots["mesh-pool-free"].multi
    assert roots["kv-handoff-lane"].kind == "declared"
    # The step agreement runs on the engine loop.
    assert "engine-loop" in get_thread_map(tree_index()).roots_of(("parallel/step_sync.py", "StepSync.agree"))


def test_thread_roots_differs_from_the_jax_file_only_in_its_table():
    """``analysis/thread_roots.py`` is the JAX file but for ``DECLARED_ROOTS``,
    which holds the JAX entries first, then the port's."""
    import radixmesh_tpu.analysis.thread_roots as jtr

    from radixmesh_tpu_torch.analysis.thread_roots import DECLARED_ROOTS

    root = Path(__file__).resolve().parents[1]

    def code(path):
        tree = ast.parse(path.read_text())
        kept = [n for n in tree.body if not (isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "DECLARED_ROOTS" for t in n.targets))
            and not (isinstance(n, ast.AnnAssign) and getattr(n.target, "id", None) == "DECLARED_ROOTS")]
        for node in ast.walk(ast.Module(body=kept, type_ignores=[])):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return [ast.dump(n) for n in kept]

    assert code(root / "radixmesh_tpu_torch/analysis/thread_roots.py") == \
        code(root / "radixmesh_tpu/analysis/thread_roots.py")
    assert DECLARED_ROOTS[: len(jtr.DECLARED_ROOTS)] == jtr.DECLARED_ROOTS


def test_kv_transfer_bind_publishes_under_the_lock():
    """``KVTransferPlane.bind`` assigns the staging ring, its free list and
    the layout under ``_lock`` (``stats()`` reads them from caller threads
    while a lane binds lazily): the guarded-by checker's verdict on the file
    is clean before any suppression, and the assignments sit in the
    ``with``."""
    from radixmesh_tpu_torch.analysis import check_tree, tree_index
    from radixmesh_tpu_torch.analysis.core import iter_functions

    raw = [f for f in check_tree().raw_by_checker["guarded-by"] if f.file == "cache/kv_transfer.py"]
    assert not raw, "\n".join(map(str, raw))
    tree = tree_index().module("cache/kv_transfer.py").tree
    bind = next(fn for qual, _, fn in iter_functions(tree) if qual == "KVTransferPlane.bind")
    locked = set()
    for node in ast.walk(bind):
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr) == "self._lock" for item in node.items):
            locked |= {ast.unparse(t) for n in ast.walk(node) if isinstance(n, ast.Assign) for t in n.targets}
    stores = {ast.unparse(t) for n in ast.walk(bind) if isinstance(n, ast.Assign) for t in n.targets
              if ast.unparse(t).startswith("self.")}
    assert {"self._free_bufs", "self._ring", "self._layout"} <= locked
    assert stores <= locked, stores - locked


def test_plane_is_rooted_in_the_port():
    """The default root and the fixture roots are the port's checkout: the
    package directory, then ``tests/fixtures/analysis`` and the port's own
    ``tests/fixtures/analysis_torch``."""
    import radixmesh_tpu_torch
    from radixmesh_tpu_torch.analysis.controls import default_fixtures_roots
    from radixmesh_tpu_torch.analysis.core import PACKAGE, package_root

    assert PACKAGE == "radixmesh_tpu_torch"
    assert package_root() == Path(radixmesh_tpu_torch.__file__).resolve().parent
    shared, own = default_fixtures_roots()
    assert shared == _REPO / "tests" / "fixtures" / "analysis" and own == _PORT_FIXTURES
    assert shared.is_dir() and own.is_dir()


def test_artifact_round_never_takes_a_jax_name(tmp_path):
    """The CLI's artifact is ``ANALYSIS_torch_r{N}``: N is one past every
    other plane's round (the JAX ANALYSIS artifacts included in neither
    count), a rerun of the round overwrites its own file only at the same
    schema version, and the JAX CLI's round pattern does not match the
    name."""
    import json
    import re

    from radixmesh_tpu_torch.analysis.report import ANALYSIS_SCHEMA_VERSION
    from radixmesh_tpu_torch.meshcheck import analysis_round

    for name in ("TIER_r15.json", "ANALYSIS_r11.json", "ANALYSIS_r30.json"):
        (tmp_path / name).write_text("{}")
    assert analysis_round(str(tmp_path)) == 16
    own = tmp_path / "ANALYSIS_torch_r16.json"
    own.write_text(json.dumps({"schema_version": ANALYSIS_SCHEMA_VERSION}))
    assert analysis_round(str(tmp_path)) == 16
    own.write_text(json.dumps({"schema_version": 1}))
    assert analysis_round(str(tmp_path)) == 17
    assert not re.fullmatch(r"[A-Z_]+_r(\d+)\.json", own.name)


def test_cli_refuses_to_write_over_a_jax_artifact(tmp_path, capsys):
    """Exit 2, before any analysis, for the JAX CLI's round name or a file
    holding the JAX package's report; nothing is written."""
    import json

    from radixmesh_tpu_torch.meshcheck import main

    jax_named = tmp_path / "ANALYSIS_r11.json"
    assert main(["--write-artifact", "--out", str(jax_named)]) == 2
    assert not jax_named.exists()
    other = tmp_path / "report.json"
    other.write_text(json.dumps({"package": "radixmesh_tpu", "clean": True}))
    assert main(["--write-artifact", "--out", str(other)]) == 2
    assert json.loads(other.read_text())["package"] == "radixmesh_tpu"
    assert capsys.readouterr().err.count("JAX package's ANALYSIS artifact") == 2
