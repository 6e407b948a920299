"""The port's examples (``examples/torch_*.py``) run in-process on the CPU
at their smallest settings: each prints the lines of its JAX twin and its
``OK`` (an assertion failing inside raises). The shrinking options
(``--dataset``, ``--samples``, ``--steps``) are the examples' own; their
defaults are the reference's."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.checkpoint import ckpt
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ok(capsys):
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK"), out
    return out


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["stacked", "streaming"])
def test_e2e_bmf_webscale(streaming, tmp_path, capsys, one_torch_thread):
    path = tmp_path / "pp"
    argv = ["--dataset", "movielens", "--samples", "12", "--device", "cpu",
            "--ckpt", str(path)] + (["--streaming"] if streaming else [])
    res = _example("torch_e2e_bmf_webscale").main(argv)
    out = _ok(capsys)
    assert f"BMF+PP[{'streaming' if streaming else 'stacked'}]" in out
    I, J = (int(n) for n in out.split("grid ")[1].split(",")[0].split("x"))
    assert I * J == (32 if streaming else 4)
    assert ckpt.manifest(path)["rmse"] == res.rmse
    like = {"U_eta": res.U_agg.eta, "U_Lam": res.U_agg.Lambda,
            "V_eta": res.V_agg.eta, "V_Lam": res.V_agg.Lambda}
    back = ckpt.restore(path, like)
    for k, t in like.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy())


def test_pp_block_exploration(capsys, one_torch_thread):
    rows = _example("torch_pp_block_exploration").main(
        ["--dataset", "mini", "--samples", "6", "--device", "cpu"])
    out = _ok(capsys)
    assert len(rows) == 6 and "squareness" in out
    assert all(np.isfinite(r[2]) for r in rows)


def test_distributed_block(capsys, one_torch_thread):
    rmse = _example("torch_distributed_block").main(
        ["--dataset", "mini", "--samples", "8", "--device", "cpu"])
    out = _ok(capsys)
    assert "8-way distributed Gibbs" in out
    assert "communication per sweep" in out
    assert np.isfinite(rmse)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "mixtral_8x7b",
                                  "internvl2_1b"])
def test_llm_smoke_train(arch, capsys, one_torch_thread):
    mod = _example("torch_llm_smoke_train")
    assert {"llama3_8b", "qwen3_4b", arch} <= set(mod.TRAINABLE)
    assert not {"zamba2_7b", "rwkv6_7b", "whisper_medium"} & set(
        mod.TRAINABLE)
    losses = mod.main(["--arch", arch, "--steps", "12", "--device", "cpu"])
    _ok(capsys)
    assert len(losses) == 12 and all(np.isfinite(losses))
