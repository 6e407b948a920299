"""repro_torch.convert: reference state -> port -> numpy round trips, and
the port's import isolation from JAX and the reference package."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.core import gibbs as TG
from repro_torch.core import posterior as TP


def _np(obj):
    return {k: np.asarray(v) for k, v in obj._asdict().items()}


def test_round_trip_of_reference_state():
    import jax
    import jax.numpy as jnp
    from repro.core import bmf as JB
    from repro.core import gibbs as JG
    from repro.core import posterior as JP
    from repro.data import sparse as JSP
    from repro.data import synthetic as JSYN
    coo, _ = JSYN.generate("mini", seed=0)
    jcsr = JSP.coo_to_padded_csr(coo)
    csr = CV.padded_csr_from_numpy(
        dict(idx=np.asarray(jcsr.idx), val=np.asarray(jcsr.val),
             mask=np.asarray(jcsr.mask), n_cols=jcsr.n_cols), device="cpu")
    assert csr.idx.dtype == torch.int32 and csr.n_cols == jcsr.n_cols
    back = CV.to_numpy(csr)
    for f in ("idx", "val", "mask"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jcsr, f)))

    rng = np.random.default_rng(0)
    g = JP.RowGaussians(jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
                        jnp.eye(3)[None].repeat(5, 0))
    tg = CV.row_gaussians_from_numpy(_np(g), device="cpu")
    assert isinstance(tg, TP.RowGaussians)
    for k, v in CV.to_numpy(tg).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(g, k)))

    nw = JP.default_nw(4)
    tnw = CV.normal_wishart_from_numpy(_np(nw), device="cpu")
    for k, v in CV.to_numpy(tnw).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(nw, k)))

    U, V = JB.init_factors(jax.random.key(0), 6, 4, 3)
    tU, tV = CV.factors_from_numpy(np.asarray(U), np.asarray(V), "cpu")
    np.testing.assert_array_equal(CV.to_numpy(tU), np.asarray(U))
    np.testing.assert_array_equal(CV.to_numpy(tV), np.asarray(V))

    acc = JG.GibbsAccumulators(
        pred_sum=jnp.arange(4.0), pred_cnt=jnp.asarray(3.0),
        U_sum=jnp.ones((6, 3)), U_outer=jnp.ones((6, 3, 3)),
        V_sum=jnp.ones((4, 3)), V_outer=jnp.ones((4, 3, 3)))
    tacc = CV.accumulators_from_numpy(_np(acc), device="cpu")
    assert isinstance(tacc, TG.GibbsAccumulators)
    for k, v in CV.to_numpy(tacc).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(acc, k)))

    Ua, Va = CV.aggregates_from_numpy(_np(g), _np(g), device="cpu")
    np.testing.assert_array_equal(CV.to_numpy(Va)["Lambda"],
                                  np.asarray(g.Lambda))

    cfg = JB.BMFConfig(K=10, sweep_fused=True, sweep_dtype="bf16")
    tcfg = CV.bmf_config_from_dict(cfg._asdict())
    assert tcfg._asdict() == cfg._asdict()
    with pytest.raises(KeyError):
        CV.bmf_config_from_dict({"K": 3, "bogus": 1})


def test_port_imports_neither_jax_nor_the_reference():
    """A fresh interpreter imports every module of the port (walked with
    ``pkgutil``, so new modules are covered) and the smoke script; no
    ``jax`` or ``repro`` module may be loaded. The walk skips a directory
    without ``__init__.py`` silently, so modules of the sub-packages are
    asserted among the names walked."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.models.model' in names, names\n"
        "assert 'repro_torch.kernels.decode_attention.ops' in names, names\n"
        "assert 'repro_torch.serving.scoring' in names, names\n"
        "assert 'repro_torch.baselines.sgd' in names, names\n"
        "for m in ('core.topology', 'core.distributed', 'launch.mesh',\n"
        "          'analysis.op_passes', 'launch.bmf_lint',\n"
        "          'roofline.analysis', 'roofline.op_cost',\n"
        "          'launch.bmf_dryrun'):\n"
        "    assert 'repro_torch.' + m in names, names\n"
        "sys.path.insert(0, '..')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("arch,kw", [
    ("zamba2_7b", dict(n_layers=9, d_model=512, shared_attn_period=4)),
    ("rwkv6_7b", dict(n_layers=8, d_model=512))],
    ids=["hybrid", "ssm"])
def test_recurrent_params_round_trip_applies_the_cast_rule(arch, kw):
    """The hybrid and ssm pytrees (numpy -> port -> numpy) in the bf16
    serving layout, at a width where the reference's ``_cast_tree`` rule
    casts some small parameters and not others because it looks at the
    stacked (L, …) arrays: each parameter is stored in bf16 exactly when
    the reference casts it, and the values come back equal."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from torch_helpers import llm_cfgs, np_tree
    jcfg, cfg = llm_cfgs(arch, **kw)
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    cast = JM._cast_tree(tree, jnp.bfloat16)
    want_dtype = {"/".join(str(getattr(k, "key", k)) for k in path):
                  a.dtype == jnp.bfloat16
                  for path, a in jax.tree_util.tree_flatten_with_path(cast)[0]}
    got_dtype = {}
    for name, t in params.named_parameters():
        path, layer = CV._tree_path(name)
        got_dtype.setdefault("/".join(path), set()).add(
            t.dtype == torch.bfloat16)
    assert {k: {v} for k, v in want_dtype.items()} == got_dtype
    # the rule bites below the matrices: stacked conv / mix arrays
    small = ("blocks/mixer/conv_x" if arch == "zamba2_7b"
             else "blocks/att/mix_base")
    assert want_dtype[small] and not want_dtype["final_norm/scale"]
    back = CV.llm_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), cast)
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, w)


def test_serve_dtype_is_the_cast_rule():
    """``model.serve_dtype`` on the shapes of the rule's edge: more than
    16,384 elements and ndim >= 2, counted on the stacked array."""
    from repro_torch.configs import base as TCB
    from repro_torch.models import model as TM
    cfg = TCB.get_config("zamba2_7b")
    assert TM.serve_dtype((4, 8192), cfg) == torch.bfloat16
    assert TM.serve_dtype((4, 4096), cfg) == torch.float32    # = 16,384
    assert TM.serve_dtype((16385,), cfg) == torch.float32     # 1-D
    assert TM.serve_dtype((4, 64), cfg, n_stack=81) == torch.bfloat16
    assert TM.serve_dtype((112,), cfg, n_stack=81) == torch.float32
