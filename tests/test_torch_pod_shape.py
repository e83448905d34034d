"""tools/pod_shape_check_torch.py (the port's pod-shape check) against
tools/pod_shape_check.py, the JAX tool, on the CPU.

* LOSS_RE and FLAGS equal the JAX tool's (read from its source: it runs
  its check when imported), less its platform pin;
* the comparison passes on outputs built by hand and fails, naming the
  iteration and both losses, on a rank 1e-5 off rank 0, on a missing
  iteration and on a one-device run 3e-3 off;
* one real run: 4 processes of main_torch.py (gloo, --mesh_inner 2: a
  (2, 2) mesh, the unique-compact exchange) beside one device, through
  the twin's run(), at 2,048 synthetic rows.
"""

import ast
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


twin = _load("pod_shape_check_torch")


def _jax_tool_constants():
    """FLAGS and LOSS_RE's pattern from tools/pod_shape_check.py."""
    tree = ast.parse((REPO / "tools" / "pod_shape_check.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name == "FLAGS":
                out[name] = ast.literal_eval(node.value)
            elif name == "LOSS_RE":
                out[name] = ast.literal_eval(node.value.args[0])
    return out


def test_flags_and_loss_re_equal_the_jax_tool():
    ref = _jax_tool_constants()
    i = ref["FLAGS"].index("--force_platform")
    assert ref["FLAGS"][i + 1] == "cpu"
    assert twin.FLAGS == ref["FLAGS"][:i] + ref["FLAGS"][i + 2:]
    assert twin.LOSS_RE.pattern == ref["LOSS_RE"]
    single = twin.single_flags(twin.FLAGS)
    assert not set(twin.MESH_ONLY) & set(single)
    assert len(single) == len(twin.FLAGS) - 2 * len(twin.MESH_ONLY)


def _out(losses, n=20):
    """main_torch.py's train lines (train/loop.py) for {it: loss}."""
    return "setup done\n" + "".join(
        f"Finished training it {it}/{n} of epoch 0, 12.34 ms/it, loss "
        f"{loss:.6f}\n" for it, loss in sorted(losses.items()))


BASE = {it: 0.69 - 0.001 * it for it in (1, 2, 3, 16, 20)}


def test_compare_passes_on_equal_outputs():
    near = {it: v + 1.5e-3 for it, v in BASE.items()}   # within 2e-3
    assert twin.compare([_out(near)] * 4, _out(BASE)) == sorted(BASE)


@pytest.mark.parametrize("case", ["rank_off", "missing", "one_device_off"])
def test_compare_fails(case):
    ranks = [dict(BASE) for _ in range(4)]
    single = dict(BASE)
    if case == "rank_off":
        ranks[1][16] += 1e-5
        match = r"it 16: rank 1 loss 0\.67401 against rank 0's 0\.674"
    elif case == "missing":
        del ranks[2][3]
        match = r"rank 2: iterations \[3\]"
    else:
        single[20] += 3e-3
        match = r"it 20: rank 0 loss 0\.67 against one device's 0\.673"
    with pytest.raises(twin.Mismatch, match=match):
        twin.compare([_out(r) for r in ranks], _out(single))


def test_main_exits_1_on_a_mismatch(monkeypatch):
    def run(device):
        raise twin.Mismatch("it 3: rank 0 loss 0.5 against one device's 0.6")
    monkeypatch.setattr(twin, "run", run)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        assert twin.main(["--device", "cpu"]) == 1
    assert "it 3" in err.getvalue()


def test_cards_needed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="4 CUDA cards"):
        twin.run("cuda")


def test_four_gloo_ranks_match_one_device():
    flags = list(twin.FLAGS)
    flags[flags.index("--synthetic_rows") + 1] = "2048"
    res = twin.run("cpu", flags + ["--tensor_board_filename", ""], n=4,
                   timeout=300)
    assert res["mesh"] == [2, 2] and res["processes"] == 4
    assert len(res["iters"]) >= 10
    assert max(abs(a - b) for a, b in zip(
        res["losses"], res["one_device_losses"])) < 2e-3
    assert "sharded over 4 ranks (gloo" in res["outputs"][0]
    assert "sharded over" not in res["outputs"][-1]
