"""repro_torch.staticcheck against the reference's repro.staticcheck: the
same matrix, the same planned residuals and byte ledgers, crafted defects
each found by exactly their rule, and the port's own tree clean.  The
reference's jaxpr audit (red on this JAX) is not held against: the ledger
is compared with its green ``activation_memory_report``."""
import ast
import dataclasses
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,
                                     PrecisionPolicy, SamplingPolicy,
                                     StashPolicy)
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.staticcheck import (deadcode, kernel_contracts,
                                     plan_verify, saved_audit, seed_lint)
from repro_torch.staticcheck.findings import Finding, new_findings
from repro_torch.staticcheck.matrix import _FIXED, audit_matrix, gnn_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _by_key():
    return {c.key: c for c in audit_matrix()}


def _ref_cases():
    from repro.staticcheck.matrix import audit_matrix as ref_matrix

    return {c.key: c for c in ref_matrix()}


# ------------------------------------------------------------------ matrix


def test_matrix_keys_equal_reference():
    from repro.staticcheck.matrix import audit_matrix as ref_matrix

    assert [c.key for c in audit_matrix()] == [c.key for c in ref_matrix()]
    assert len(audit_matrix()) == 34


@pytest.mark.parametrize("mechanism", ["tensor", "device"])
def test_expected_residuals_equal_reference(mechanism):
    """The planned multiset of every case equals the reference's (the
    port's int32 words are the reference's uint32 entries)."""
    from repro.offload.gnn import plan_gnn_stashes as ref_plan
    from repro.staticcheck.jaxpr_audit import expected_residuals as ref_exp

    ref = _ref_cases()
    for case in audit_matrix():
        rc = ref[case.key]
        assert case.live_nodes == rc.live_nodes
        got = saved_audit.expected_residuals(
            plan_gnn_stashes(case.cfg, case.in_dim, case.live_nodes),
            mechanism)
        want = ref_exp(ref_plan(rc.cfg, rc.in_dim, rc.live_nodes), mechanism)
        assert got == want, case.key


def _ref_report_bytes(rc) -> int:
    from repro.graph.train import activation_memory_report

    g = SimpleNamespace(n_feats=rc.in_dim, n_nodes=rc.n_nodes)
    rep = activation_memory_report(g, rc.cfg, plan=rc.plan)
    sp = rc.plan.sampling
    if sp.kind == "full":
        return rep.get("compressed_bytes", rep["fp32_bytes"])
    return rep["mesh" if sp.kind == "mesh" else "batched"][
        "peak_saved_bytes"]


@pytest.mark.parametrize("key", [c.key for c in audit_matrix()])
def test_saved_ledger_matches_reference_report(key):
    """Every case audits clean on the CPU, and its saved-tensor ledger is
    within LEDGER_RTOL of the reference's memory report (exact here)."""
    r = saved_audit.audit_case(_by_key()[key], device="cpu")
    assert r.findings == []
    want = _ref_report_bytes(_ref_cases()[key])
    assert abs(r.ledger_bytes - want) <= saved_audit.LEDGER_RTOL * want
    assert r.ledger_bytes == want == r.report_bytes


# ------------------------------------------------------------ saved-audit


def _tensor_case_setup():
    case = _by_key()["full/fixed/tensor/fused-off"]
    model, setup = saved_audit._case_setup(case, torch.device("cpu"))
    return model, setup


class _LeakyAttr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.raw = torch.zeros(257)      # a raw f32 activation on ctx
        return h.clone()

    @staticmethod
    def backward(ctx, g):
        return g


class _LeakySaved(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(torch.zeros(257))
        return h.clone()

    @staticmethod
    def backward(ctx, g):
        return g


@pytest.mark.parametrize("leak", [_LeakyAttr, _LeakySaved],
                         ids=["ctx-attribute", "save_for_backward"])
def test_residual_leak_is_exactly_detected(leak):
    _, (forward, inputs, splan, mech) = _tensor_case_setup()
    got = saved_audit.audit_forward(lambda: leak.apply(forward()), inputs,
                                    splan, mech, "crafted")
    assert [f.rule for f in got.findings] == ["residual-leak"]
    assert "escaped the quantizer" in got.findings[0].message
    assert got.ledger_bytes == saved_audit.report_bytes(
        _by_key()["full/fixed/tensor/fused-off"]) + 257 * 4


def test_missing_stash_is_exactly_detected():
    """A dropped stash field (layer 0's ReLU mask) is its planned entry
    missing, and nothing else."""
    _, (forward, inputs, splan, mech) = _tensor_case_setup()

    def dropping():
        out = forward()
        out.grad_fn.stash[0].pop("mask")
        return out

    got = saved_audit.audit_forward(dropping, inputs, splan, mech, "crafted")
    assert [(f.rule, f.where) for f in got.findings] == [
        ("missing-stash", "crafted/layer0/mask")]


def test_unplanned_integer_residual_detected():
    _, (forward, inputs, splan, mech) = _tensor_case_setup()

    def extra():
        out = forward()
        out.grad_fn.stash[1]["junk"] = torch.zeros(9, dtype=torch.int32)
        return out

    got = saved_audit.audit_forward(extra, inputs, splan, mech, "crafted")
    assert [f.rule for f in got.findings] == ["unplanned-residual"]


def test_host_store_drains_after_backward():
    """Host placements hold the plan's bytes in the store after the
    forward and none after one backward."""
    from repro_torch.offload.engine import host_store_bytes

    case = _by_key()["full/fixed/paged/fused-off"]
    model, (forward, inputs, splan, mech) = saved_audit._case_setup(
        case, torch.device("cpu"))
    before = host_store_bytes()
    fwd = saved_audit.audit_forward(forward, inputs, splan, mech, "h")
    assert (fwd.findings, fwd.n_saved) == ([], 0)
    assert host_store_bytes() - before == splan.total_bytes
    assert saved_audit.drain(fwd, model.flat_params(), "h", before) == []
    assert host_store_bytes() == before


# ------------------------------------------------------------ plan-verify


@pytest.mark.parametrize("field,make", [
    ("sampling.kind", lambda: SamplingPolicy(kind="bogus")),
    ("sampling.n_parts", lambda: SamplingPolicy(kind="partition",
                                                n_parts=0)),
    ("sampling.grad_accum", lambda: SamplingPolicy(kind="mesh", n_parts=4,
                                                   grad_accum=2)),
    ("precision.kind", lambda: PrecisionPolicy(kind="bogus")),
    ("precision.bit_budget", lambda: PrecisionPolicy(kind="autoprec")),
    ("stash.kind", lambda: StashPolicy(kind="bogus")),
    ("stash.placement", lambda: StashPolicy(kind="arena",
                                            placement="bogus")),
    ("kernel.impl", lambda: KernelPolicy(impl="bogus")),
    ("kernel.fused", lambda: KernelPolicy(fused="bogus")),
])
def test_plan_validation_names_offending_field(field, make):
    with pytest.raises(ValueError, match=field.replace(".", r"\.")) as ei:
        make()
    assert "bogus" in str(ei.value) or "=" in str(ei.value)


def test_verify_legacy_kwargs_reuses_field_messages():
    got = plan_verify.verify_legacy_kwargs(offload="bogus")
    assert len(got) == 1 and got[0].rule == "policy-field"
    assert "stash.placement" in got[0].message


def _tensor_splan():
    return plan_gnn_stashes(gnn_cfg(_FIXED), 32, 256)


@pytest.mark.parametrize("layout", ["offset", "start"])
def test_arena_overlap_is_exactly_detected(layout):
    """rp_seed slid inside the packed span, in the planned or the
    allocated layout: bounds and geometry stay valid."""
    splan = _tensor_splan()
    lp = splan.layers[0]
    bad = dataclasses.replace(lp, rp_seed=dataclasses.replace(
        lp.rp_seed, **{layout: getattr(lp.packed, layout)}))
    mutated = dataclasses.replace(splan, layers=(bad,) + splan.layers[1:])
    got = plan_verify.verify_stash_plan(mutated)
    assert [f.rule for f in got] == ["arena-overlap"]
    assert "u32 arena" in got[0].message


def test_misaligned_arena_start_detected():
    splan = _tensor_splan()
    lp = splan.layers[1]
    bad = dataclasses.replace(lp, zero=dataclasses.replace(
        lp.zero, start=lp.zero.start + 1))
    mutated = dataclasses.replace(splan, layers=splan.layers[:1] + (bad,))
    rules = {f.rule for f in plan_verify.verify_stash_plan(mutated)}
    assert "arena-alignment" in rules


def test_ragged_mask_floor_is_exactly_detected():
    splan = _tensor_splan()
    lp = next(l for l in splan.layers if l.mask is not None)
    ragged = lp.mask_elems + 5
    bad = dataclasses.replace(
        lp, mask_elems=ragged,
        mask=dataclasses.replace(lp.mask, size=ragged // 32))
    mutated = dataclasses.replace(
        splan, layers=tuple(bad if l is lp else l for l in splan.layers))
    got = plan_verify.verify_stash_plan(mutated)
    assert [f.rule for f in got] == ["mask-alignment"]
    assert "ragged tail" in got[0].message


def test_real_matrix_verifies_clean():
    for case in audit_matrix():
        assert plan_verify.verify_plan(case.plan, case.cfg, case.in_dim,
                                       case.n_nodes, where=case.key) == []


def test_kv_matrix_verifies_clean():
    assert plan_verify.verify_kv_matrix() == []


def _kv_layout(**kw):
    from repro_torch.serving.kvcache import KVCacheConfig, plan_kv_layout

    return plan_kv_layout(KVCacheConfig(**kw), n_layers=2, n_kv_heads=4,
                          d_head=16)


def test_kv_page_overlap_and_bounds_exactly_detected():
    lay = _kv_layout(bits=4, n_pages=8)
    w = lay.words_per_page
    got = plan_verify.verify_kv_layout(
        lay, segments=[(0, 0, 0, w), (0, 1, w - 1, w)])
    assert [f.rule for f in got] == ["kv-page-overlap"]
    got = plan_verify.verify_kv_layout(
        lay, segments=[(1, 7, lay.total_words - w + 1, w)])
    assert [f.rule for f in got] == ["kv-page-bounds"]
    got = plan_verify.verify_kv_layout(lay, segments=[(0, 0, 0, w - 2)])
    assert [f.rule for f in got] == ["kv-page-geometry"]


def test_kv_word_alignment_exactly_detected():
    lay = dataclasses.replace(_kv_layout(bits=8), group_size=6)
    rules = {f.rule for f in plan_verify.verify_kv_layout(lay)}
    assert "kv-page-alignment" in rules


def test_mesh_cross_policy_rules():
    plan = ExecutionPlan(
        sampling=SamplingPolicy(kind="mesh", n_parts=4),
        stash=StashPolicy(kind="arena", placement="device"),
        kernel=KernelPolicy(fused="on"))
    rules = {f.rule for f in plan_verify.verify_combination(plan)}
    assert rules == {"mesh-stash", "mesh-fused"}


def test_mesh_divisor_follows_the_port():
    """A divergence, stated: 6 parts on 4 ranks.  The reference shrinks its
    mesh to 3 devices (no finding); the port's graph_mesh raises, so its
    verifier reports it."""
    from repro.engine.plan import ExecutionPlan as RefPlan
    from repro.engine.plan import SamplingPolicy as RefSampling
    from repro.staticcheck import plan_verify as ref_verify

    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=6))
    got = plan_verify.verify_combination(plan, devices=4)
    assert [f.rule for f in got] == ["mesh-divisor"]
    ref = RefPlan(sampling=RefSampling(kind="mesh", n_parts=6))
    assert ref_verify.verify_combination(ref, devices=4) == []
    # where the reference's mesh would degenerate, both report it
    plan7 = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=7))
    ref7 = RefPlan(sampling=RefSampling(kind="mesh", n_parts=7))
    assert [f.rule for f in plan_verify.verify_combination(
        plan7, devices=4)] == ["mesh-divisor"]
    assert [f.rule for f in ref_verify.verify_combination(
        ref7, devices=4)] == ["mesh-divisor"]


def test_obs_calibration_needs_telemetry_channel():
    from repro_torch.obs import ObsPolicy

    plan = ExecutionPlan(
        precision=PrecisionPolicy(kind="autoprec", bit_budget=2.0,
                                  calibration="obs"))
    got = plan_verify.verify_combination(plan)
    assert [f.rule for f in got] == ["obs-calibration"]
    ok = dataclasses.replace(
        plan, obs=ObsPolicy(enabled=True, quant_stats=True))
    assert plan_verify.verify_combination(ok) == []


# -------------------------------------------------------- kernel-contracts


def test_over_budget_fused_backward_tile_is_exactly_detected(monkeypatch):
    """A backward tile of 128 rows of dw by 256 columns needs more shared
    memory than the card has: exactly the smem-budget contract."""
    launch = kernel_contracts.Launch("fused", 169_343, 512, 256, 2, 256)
    assert kernel_contracts.check_launch(launch) == []
    real = kernel_contracts.fused_matmul.tile
    monkeypatch.setattr(kernel_contracts.fused_matmul, "tile",
                        lambda n: (128, 256, 32) if n > 64 else real(n))
    got = kernel_contracts.check_launch(launch)
    assert [f.rule for f in got] == ["smem-budget"]
    assert "backward" in got[0].message


def test_straddling_fused_layout_is_exactly_detected():
    got = kernel_contracts.check_launch(
        kernel_contracts.Launch("fused", 100, 96, 64, 2, 64))
    assert [f.rule for f in got] == ["tile-block-alignment"]


def test_launch_shared_memory_is_the_kernels_arithmetic():
    """The figures PERF.md records from ptxas for the slice's layers."""
    fwd = kernel_contracts.fwd_launch
    bwd = kernel_contracts.bwd_launch
    assert fwd(256, 256, 256).smem == 102_400
    assert fwd(512, 40, 256).smem == 73_728
    assert bwd(169_343, 512, 256, 256, 2).smem == 226_304
    assert bwd(169_343, 512, 40, 256, 2).smem == 149_504
    b = bwd(169_343, 256, 256, 256, 2)
    assert (b.splits, b.scratch) == (32, 8_388_608)


def test_matrix_and_smoke_launches_are_contract_clean():
    """Every launch of the plan matrix, and every quant and fused shape
    chip_smoke.py launches on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.smoke_launches()
    assert {e.kind for e in launches} == {"quant", "fused", "rp"}
    assert kernel_contracts.run(launches) == []


# --------------------------------------------------------------- seed-lint


def test_seed_constant_reuse_is_exactly_detected():
    got = seed_lint.lint_source(
        "def stash_seed(li):\n    return (li + 1) * 7919\n",
        "repro_torch/somewhere/mod.py")
    assert [f.rule for f in got] == ["seed-constant"]
    assert "7919" in got[0].message


def test_seed_constants_allowed_in_scheme_home():
    src = "SR_SEED_PRIME = 7919\n"
    assert seed_lint.lint_source(src, "repro_torch/engine/seeds.py") == []
    assert len(seed_lint.lint_source(src, "repro_torch/other.py")) == 1


def test_manual_seed_arithmetic_detected():
    src = ("import torch\n\n"
           "def gen(seed):\n"
           "    return torch.Generator().manual_seed(seed + 3)\n")
    got = seed_lint.lint_source(src, "repro_torch/graph/mod.py")
    assert [f.rule for f in got] == ["prng-key-arith"]
    assert seed_lint.lint_source(src, "repro_torch/engine/seeds.py") == []
    plain = "import torch\ng = torch.Generator().manual_seed(0)\n"
    assert seed_lint.lint_source(plain, "repro_torch/graph/mod.py") == []


def test_host_nondeterminism_in_training_path_detected():
    src = ("import time\nimport torch\n\n"
           "class F(torch.autograd.Function):\n"
           "    @staticmethod\n"
           "    def forward(ctx, x):\n"
           "        return x + time.time()\n")
    got = seed_lint.lint_source(src, "repro_torch/mod.py")
    assert [f.rule for f in got] == ["jit-host-nondeterminism"]
    outside = "import time\n\ndef f(x):\n    return x + time.time()\n"
    assert seed_lint.lint_source(outside, "repro_torch/mod.py") == []


def test_sr_seed_reuse_detected():
    src = ("def f(x, y):\n"
           "    a = sr_seed(3)\n"
           "    b = sr_seed(3)\n"
           "    return a, b\n")
    got = seed_lint.lint_source(src, "repro_torch/mod.py")
    assert [f.rule for f in got] == ["sr-seed-reuse"]


@pytest.mark.parametrize("read", ["x.item()", "x.cpu()", "x.tolist()",
                                  "x.numpy()", "torch.cuda.synchronize()"])
def test_host_read_on_training_path_detected(read):
    src = ("import torch\nfrom torch import nn\n\n"
           "class M(nn.Module):\n"
           "    def forward(self, x):\n"
           f"        y = {read}\n"
           "        return x\n")
    got = seed_lint.lint_source(src, "repro_torch/graph/train.py")
    assert [f.rule for f in got] == ["host-callback-tap"]
    assert seed_lint.lint_source(src, "repro_torch/obs/quantstats.py") == []
    assert seed_lint.lint_source(src, "repro_torch/offload/engine.py") == []


def test_obs_tap_on_dataflow_path_detected():
    src = ("from repro_torch.obs.quantstats import tap\n\n"
           "def f(x):\n    tap(print, x)\n    return x\n")
    for fname in ("repro_torch/engine/forward.py",
                  "repro_torch/offload/engine.py",
                  "repro_torch/offload/arena.py"):
        assert ["obs-tap-dataflow"] == [
            f.rule for f in seed_lint.lint_source(src, fname)]
    assert seed_lint.lint_source(src, "repro_torch/engine/runner.py") == []


def test_port_seed_discipline_is_clean():
    assert seed_lint.run() == []


# ---------------------------------------------------------------- dead-code


def test_dead_code_crafted(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(
        "def used():\n    return 1\n\n\ndef unused():\n    return 2\n")
    (pkg / "other.py").write_text(
        "from repro_torch.mod import used\n\n\ndef caller():\n"
        "    return used()\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_x.py").write_text(
        "from repro_torch.other import caller\ncaller()\n")
    got = deadcode.sweep(tmp_path)
    assert [f.rule for f in got] == ["unused-symbol"]
    assert "repro_torch.mod.unused" in got[0].message


def test_reexport_is_transparent(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("from repro_torch.mod import shim\n")
    (pkg / "mod.py").write_text("def shim():\n    return 0\n")
    got = deadcode.sweep(tmp_path)
    assert [f.rule for f in got] == ["unused-symbol"]
    # a use from the smoke script beside the tree keeps it alive
    (tmp_path / "chip_smoke.py").write_text(
        "from repro_torch.mod import shim\nshim()\n")
    assert deadcode.sweep(tmp_path) == []


# ------------------------------------------------------------ CLI/baseline


def test_fingerprint_ignores_message_rewording():
    a = Finding("p", "r", "w", "old text")
    b = Finding("p", "r", "w", "new text")
    assert a.fingerprint() == b.fingerprint()
    assert new_findings([b], {a.fingerprint()}) == []
    assert new_findings([b], set()) == [b]


def test_cli_gates_on_new_findings(tmp_path, monkeypatch):
    from repro_torch.staticcheck import cli

    baseline = tmp_path / "baseline.json"
    assert cli.main(["--passes", "kernel-contracts",
                     "--baseline", str(baseline)]) == 0
    assert cli.main(["--passes", "bogus-pass",
                     "--baseline", str(baseline)]) == 2
    crafted = [Finding("seed-lint", "seed-constant", "x.py:1", "crafted")]
    monkeypatch.setattr(cli.seed_lint, "run", lambda: crafted)
    assert cli.main(["--passes", "seed-lint",
                     "--baseline", str(baseline)]) == 1
    assert cli.main(["--passes", "seed-lint", "--baseline", str(baseline),
                     "--write-baseline"]) == 0
    assert cli.main(["--passes", "seed-lint",
                     "--baseline", str(baseline)]) == 0


def test_cli_ci_on_the_cpu_is_clean_and_cached(tmp_path, capsys):
    """``python -m repro_torch.staticcheck --ci --device cpu`` exits 0
    with the committed (empty) baseline; a second run reads the cache."""
    from repro_torch.staticcheck import cli

    assert cli.main(["--ci", "--device", "cpu", "--cache",
                     str(tmp_path / "c.json")]) == 0
    assert capsys.readouterr().out.count(": ledger ") == 34
    assert cli.main(["--ci", "--device", "cpu", "--passes", "saved-audit",
                     "--cache", str(tmp_path / "c.json")]) == 0
    assert "ledger" not in capsys.readouterr().out   # served from the cache


def test_committed_baseline_is_empty():
    from repro_torch.staticcheck import cli
    from repro_torch.staticcheck.findings import load_baseline

    assert cli.DEFAULT_BASELINE.exists()
    assert load_baseline(cli.DEFAULT_BASELINE) == set()


def test_staticcheck_and_examples_import_no_jax():
    """The port's checker and examples import torch, never jax or the
    reference package."""
    files = sorted((ROOT / "src" / "repro_torch" / "staticcheck").glob(
        "*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) == 14
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
