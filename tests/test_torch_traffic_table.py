"""tools/traffic_table_torch.py (the port's collective-bytes table) against
tools/traffic_table.py, the JAX tool, on the CPU.

* the title, header, rule, rows and closing line are the JAX tool's: both
  render the same records alike;
* at 2 and 4 flat gloo ranks and on the (2, 2) mesh, for hash and CAFE,
  the twin's rows (its own spawned ranks) record the totals and the
  collectives that tests/torch_dist_worker.py's collective_totals records
  at the same flags in another set of ranks, within the JAX tool's
  criterion (the JAX package's compiled totals of
  tests/test_torch_traffic_model.py stated beside), with bytes by axis
  summing to the total;
* chip_smoke's traffic_table phase holds K1 against its plain version on
  the inputs the CAFE step gave it;
* a row that breaks the criterion, or a mesh whose ranks fail, exits 1;
  too few cards raise;
* the ranks' group start (parallel/mesh.init_file_group) retries gloo's
  "Connection closed by peer" on a fresh store and raises other errors.
"""

import contextlib
import importlib.util
import io
import sys
import threading
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as w
from cafe_tpu_torch.parallel import mesh as mesh_mod
from test_torch_traffic_model import JAX_COMPILED

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MESHES = [(2, 0), (4, 0), (4, 2)]
METHODS = ["hash", "cafe"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


twin = _load("traffic_table_torch")


def _fake(n, inner, method="cafe", total=1_300_000, model=1_290_000,
          over=0):
    return {"n": n, "inner": inner, "method": method,
            "batch": max(128, 2 * n), "collectives": 12,
            "hlo_total": total, "largest": 1_205_572,
            "model_total": model, "table_bytes": 1_343_488,
            "per_axis": ({"data": total - 96_000, "dcn": 50_000,
                          "ici": 46_000} if inner else {"data": total}),
            "by_op": {}, "bound": 2_411_144, "over": over}


def test_header_and_rows_equal_the_jax_tool(monkeypatch):
    """Both tools print the same title, header, rule, row and closing
    line for the same records (the JAX tool's per-axis "-" of a flat mesh
    aside: its child classifies axes only on a two-level mesh)."""
    jtool = _load("traffic_table")
    recs = {(n, inner): _fake(n, inner) for n, inner in
            [(4, 0), (16, 0), (16, 8)]}
    for r in recs.values():
        if not r["inner"]:
            r["per_axis"] = {}
    monkeypatch.setattr(jtool, "run_one",
                        lambda n, inner, method: recs[n, inner])
    monkeypatch.setattr(sys, "argv", ["traffic_table.py", "--method", "cafe",
                                      "--sizes", "4", "16"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jtool.main()
    want = out.getvalue().splitlines()
    got = (twin.TITLE.format(method="cafe") + "\n" + twin.HEADER + "\n"
           + twin.RULE + "\n"
           + "\n".join(twin.format_row(recs[k]) for k in recs) + "\n"
           + twin.CRITERION).splitlines()
    assert got == want
    assert twin.shape_label(16, 8) == "2x8 dcn/ici"
    assert twin.parse_mesh("4x2") == (8, 2) and twin.parse_mesh("8") == (8, 0)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{(n, inner): (twin's records, collective_totals' records)} for
    hash and CAFE."""
    out = {}
    for n, inner in MESHES:
        rows = twin.rows(n, inner, METHODS, device="cpu")
        argvs = [twin.config_argv(n, inner, m, "cpu") for m in METHODS]
        totals = w.run_ranks(w.collective_totals, n,
                             tmp_path_factory.mktemp(f"n{n}_{inner}"),
                             argvs, inner=inner)[0]
        out[n, inner] = (rows, totals)
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,inner", MESHES)
def test_rows_equal_collective_totals(recorded, n, inner, method):
    rows, totals = recorded[n, inner]
    i = METHODS.index(method)
    r, t = rows[i], totals[i]
    assert r["method"] == method and r["n"] == n and r["inner"] == inner
    assert r["hlo_total"] == t["total"]
    assert r["collectives"] == len(t["collectives"])
    assert r["largest"] == max(c[2] for c in t["collectives"])
    ratio = twin.ratio(r)
    assert twin.passes(r), {
        "port_recorded": r["hlo_total"], "model": r["model_total"],
        "ratio": ratio, "bounds": (0.5, twin.UPPER[method]),
        "over_bound": r["over"],
        "jax_compiled_at_test_torch_traffic_model_flags": {
            k: v for k, v in JAX_COMPILED.items() if k[0] == method}}


@pytest.mark.parametrize("n,inner", MESHES)
def test_by_axis_sums_to_total(recorded, n, inner):
    for r in recorded[n, inner][0]:
        assert sum(r["per_axis"].values()) == r["hlo_total"]
        assert sum(r["by_op"].values()) == r["hlo_total"]
        want = {"data", "dcn", "ici"} if inner else {"data"}
        assert set(r["per_axis"]) == want, r["per_axis"]


def test_one_rank_in_process():
    """World size 1 in this process (chip_smoke's traffic_table phase):
    both methods within the criterion, every byte on the data axis."""
    for r in twin.rows(1, 0, METHODS, device="cpu"):
        assert twin.passes(r), r
        assert set(r["per_axis"]) == {"data"}
    assert not dist.is_initialized()


def test_chip_smoke_phase_holds_k1(monkeypatch, tmp_path):
    """chip_smoke's traffic_table phase on the CPU: no K1 launch counted,
    and K1's wrapper held against its plain version on the 512 lanes
    (batch 128 x 4 fields) the CAFE step gave it."""
    from cafe_tpu_torch.kernels import KERNELS, land
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "OUT_DIR", str(tmp_path))
    rec = smoke.phase_traffic_table(twin, land, KERNELS, device="cpu")
    assert rec["launches"]["land_max"] == 0
    (case,) = rec["land_max_cases"]
    assert case["shape"][:2] == [128 * twin.FIELDS, 5], case
    assert case["max_abs_err"] == 0 and case["two_launches_equal"]
    assert (tmp_path / "tools_traffic_table.txt").exists()


@pytest.mark.parametrize("case", ["pass", "ratio", "over", "ranks_fail"])
def test_exit_code(monkeypatch, case):
    def rows(n, inner, methods, device="cuda"):
        if case == "ranks_fail":
            raise RuntimeError("audit ranks exited with [1, 0]")
        return [_fake(n, inner, methods[0],
                      total=10_000_000 if case == "ratio" else 1_300_000,
                      over=int(case == "over"))]

    monkeypatch.setattr(twin, "rows", rows)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = twin.main(["--device", "cpu", "--method", "cafe",
                          "--meshes", "2", "4x2"])
    assert code == (0 if case == "pass" else 1), out.getvalue()
    if case == "ranks_fail":
        assert "| 2 | ERROR |" in out.getvalue()
    assert twin.GLOO_NOTE in out.getvalue()


def test_too_few_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        twin.main(["--meshes", "2"])


# ---------------------------------------------------- the group's start

def _fake_group(monkeypatch, fails):
    """init_process_group / destroy_process_group stand-ins: `fails`
    {(rank, try): message} raise; the stores each try used, by rank."""
    used, destroyed = {}, []

    def init(backend, init_method, rank, world_size):
        attempt = len(used.setdefault(rank, []))
        used[rank].append(init_method)
        if (rank, attempt) in fails:
            raise RuntimeError(fails[rank, attempt])

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: destroyed.append(threading.get_ident()))
    return used, destroyed


def _ranks(world, tmp_path):
    errors = {}

    def one(rank):
        try:
            mesh_mod.init_file_group("gloo", str(tmp_path), rank, world)
        except RuntimeError as e:
            errors[rank] = str(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_group_start_retries_a_dropped_connection(monkeypatch, tmp_path):
    """Rank 1's first try drops: both ranks leave it (rank 0, whose group
    formed, destroys it) and form the group on a fresh store."""
    used, destroyed = _fake_group(monkeypatch, {
        (1, 0): "[enforce fail] Connection closed by peer [127.0.0.1]:1"})
    assert _ranks(2, tmp_path) == {}
    for r in (0, 1):
        assert used[r] == [f"file://{tmp_path}/store_0",
                           f"file://{tmp_path}/store_1"]
    assert len(destroyed) == 1


def test_group_start_raises_other_errors(monkeypatch, tmp_path):
    """Any other error ends the start on every rank, with no retry."""
    used, _ = _fake_group(monkeypatch, {(0, 0): "address in use"})
    errors = _ranks(2, tmp_path)
    assert errors[0] == "address in use"
    assert "did not form" in errors[1]
    assert all(len(v) == 1 for v in used.values())


def test_group_start_tries_a_bounded_number_of_times(monkeypatch, tmp_path):
    used, _ = _fake_group(monkeypatch, {
        (0, t): "Connection closed by peer" for t in range(10)})
    errors = _ranks(1, tmp_path)
    assert "did not form" in errors[0]
    assert len(used[0]) == mesh_mod.INIT_TRIES
