"""The port's 2-D ('block', 'data') topology layer: ``core.topology``'s
object semantics and validation, ``from_spec`` coercion, the executors'
wiring (the port of ``tests/test_topology.py``'s single-device cases), and
``run_pp`` over CPU topologies whose slots repeat "cpu": up to 4 groups
for the async and streaming executors, bitwise equal to one group, and
``distributed_mesh`` as the spelling of ``Topology(1, S)``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.core.topology import (BLOCK_AXIS, DATA_AXIS, Group,
                                       Topology, visible_devices)
from repro_torch.data import sparse as TSP
from repro_torch.data import synthetic as TSYN
from repro_torch.launch import mesh as TMESH
from torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def cpus(n):
    return ("cpu",) * n


def test_topology_shape_validation():
    with pytest.raises(ValueError, match=">= 1"):
        Topology(block=0, data=1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        Topology(block=1, data=2, devices=cpus(1))
    t = Topology(block=1, data=1)
    assert t.n_devices == 1
    assert t.groups() == (t.devices,)
    assert t.describe().startswith("topology 1x1")
    with pytest.raises(ValueError, match="group 1"):
        t.group(1)
    assert (BLOCK_AXIS, DATA_AXIS) == ("block", "data")


def test_topology_from_spec_coercions():
    t = Topology.from_spec(None)
    assert t.block == len(visible_devices()) and t.data == 1
    assert t == Topology.default()
    assert Topology.from_spec(t) is t
    t2 = Topology.from_spec((1, 1))
    assert (t2.block, t2.data) == (1, 1)
    t3 = Topology.from_spec(cpus(3))          # one group per device
    assert (t3.block, t3.data) == (3, 1)
    assert t3.devices == (torch.device("cpu"),) * 3
    for bad in ("block", (1, 2, 3), []):
        with pytest.raises(ValueError, match="topology"):
            Topology.from_spec(bad)


def test_devices_repeat_and_round_robin():
    """A device may repeat: every slot of a 2×2 topology on the CPU is the
    CPU; groups are the row-major slices; ``slots`` is a Group."""
    t = Topology(2, 2)
    assert t.devices == tuple(visible_devices()[k % len(visible_devices())]
                              for k in range(4))
    t = Topology(2, 2, devices=("cpu", "cpu", "cpu", "cpu"))
    assert t.group(1) == t.devices[2:4] and len(t.groups()) == 2
    g = t.slots(1)
    assert isinstance(g, Group) and g.index == 1 and g.size == 2
    assert g.lead == torch.device("cpu") and not g.cuda
    assert Topology.default(data=2).data == 2
    assert hash(t) == hash(Topology(2, 2, devices=cpus(4)))


def test_mesh_builders_return_the_topology():
    t = TMESH.make_pp_topology(2, 2, devices=cpus(4))
    assert t == Topology(2, 2, devices=cpus(4))
    assert TMESH.make_pp_mesh(2, 2, devices=cpus(4)) == t
    assert TMESH.make_pp_topology(3).block == 3


def test_topology_executor_wiring_errors():
    with pytest.raises(ValueError, match="stacked"):
        TENG.make_executor("stacked", topology=Topology(1, 1))
    with pytest.raises(ValueError, match="ambiguous"):
        TENG.make_executor(TENG.StackedExecutor(), topology=Topology(1, 1))
    with pytest.raises(ValueError, match="OR"):
        TENG.SerialExecutor(distributed_mesh=2, topology=Topology(1, 1))
    with pytest.raises(ValueError, match="one block at a time"):
        TENG.make_executor("serial", topology=(2, 1))
    with pytest.raises(ValueError, match="gather"):
        TENG.StreamingExecutor(topology=Topology(1, 1), comm="psum")
    with pytest.raises(ValueError, match="comm"):
        TENG.make_executor("sharded", comm="ring")
    with pytest.raises(ValueError, match="comm"):
        TENG.make_executor("serial", comm="psum")
    with pytest.raises(ValueError, match="depth"):
        TENG.AsyncExecutor(depth=0)
    with pytest.raises(ValueError, match="OR"):
        TENG.make_executor("async", topology=(1, 1), block_mesh=cpus(1))


def test_executors_consume_topology_single_device():
    """On one slot every executor accepts the degenerate topology and
    keeps its one-group behavior."""
    t = Topology(block=1, data=1, devices=cpus(1))
    assert TENG.make_executor("serial", topology=t).distributed_mesh is None
    sh = TENG.make_executor("sharded", topology=t, comm="psum")
    assert sh.topology is t and sh.comm == "psum"
    asy = TENG.make_executor("async", topology=t)
    assert asy.topology is t and asy.depth == 2
    st = TENG.make_executor("streaming", topology=t, window=3)
    assert st.topology is t and st.window == 3
    ser = TENG.make_executor("stacked", distributed_mesh=cpus(2))
    assert ser.name == "serial"
    assert ser.distributed_mesh == Topology(1, 2, devices=cpus(2))
    assert TENG.make_executor("async", block_mesh=cpus(2)).topology.block \
        == 2


@pytest.fixture(scope="module")
def conf():
    coo, p = TSYN.generate("mini", seed=13)
    train, test = TSP.train_test_split(coo, 0.15, seed=14)
    cfg = TB.BMFConfig(K=p.K, n_samples=4, burnin=1)
    part = TPA.partition(train, 3, 3)
    ref = {name: TPP.run_pp(5, part, cfg, test, executor=name, device="cpu")
           for name in ("serial", "async", "streaming")}
    return part, cfg, test, ref


def test_topology_must_fit_the_run_device(conf):
    part, cfg, test, _ = conf
    with pytest.raises(ValueError, match="does not fit"):
        TPP.run_pp(5, part, cfg, test, executor="async", device="cpu",
                   topology=Topology(2, 1, devices=("cuda:0",) * 2))


@pytest.mark.parametrize("G", [2, 3, 4])
@pytest.mark.parametrize("name", ["async", "streaming"])
def test_groups_are_bitwise_one_group(conf, name, G):
    """``run_pp(executor=..., topology=Topology(G, 1))`` for G up to 4:
    a block's noise never depends on its group, so the run is bitwise
    the one-group run, and every group took work."""
    part, cfg, test, ref = conf
    ex = (TENG.StreamingExecutor(window=2, topology=Topology(G, 1, cpus(G)),
                                 record_trace=True)
          if name == "streaming" else
          TENG.AsyncExecutor(topology=Topology(G, 1, cpus(G)),
                             record_trace=True))
    res = TPP.run_pp(5, part, cfg, test, executor=ex, device="cpu")
    want = ref[name]
    assert res.rmse == want.rmse
    torch.testing.assert_close(res.U_agg.eta, want.U_agg.eta, rtol=0, atol=0)
    torch.testing.assert_close(res.V_agg.Lambda, want.V_agg.Lambda, rtol=0,
                               atol=0)
    used = {g for ev, _, g in ex.trace if ev == "dispatch"}
    assert used == set(range(G)) if name == "async" else len(used) >= 2
    assert res.group_stats == dict(n_quarantined=0, n_steals=0,
                                   n_speculations=0, n_cancels=0)


def test_distributed_mesh_is_topology_1xS(conf):
    """``distributed_mesh`` (2 slots) and ``topology=Topology(1, 2)`` run
    the serial executor's blocks data-sharded ('psum'): equal to each
    other, and to the single-slot run within the statistics'
    reassociation."""
    part, cfg, test, ref = conf
    a = TPP.run_pp(5, part, cfg, test, device="cpu",
                   distributed_mesh=cpus(2))
    b = TPP.run_pp(5, part, cfg, test, device="cpu", executor="serial",
                   topology=Topology(1, 2, cpus(2)))
    assert a.executor == b.executor == "serial"
    assert a.rmse == b.rmse
    assert abs(a.rmse - ref["serial"].rmse) < 1e-5
    np.testing.assert_allclose(a.per_block_rmse, ref["serial"].per_block_rmse,
                               atol=1e-4)


def test_bmf_train_cli_topology(capsys):
    """``bmf_train --topology 2 2 --comm psum`` on the CPU: the sharded
    executor's groups, each block's chain over two slots."""
    from repro_torch.launch import bmf_train
    res = bmf_train.main(["--dataset", "mini", "--blocks", "4", "--samples",
                          "4", "--executor", "sharded", "--topology", "2",
                          "2", "--comm", "psum", "--device", "cpu"])
    assert np.isfinite(res.rmse) and res.executor == "sharded"
    out = capsys.readouterr().out
    assert "topology 2x2" in out and "RMSE=" in out
    res = bmf_train.main(["--dataset", "mini", "--blocks", "4", "--samples",
                          "4", "--distributed", "--device", "cpu"])
    assert res.executor == "serial"
    with pytest.raises(SystemExit):
        bmf_train.main(["--dataset", "mini", "--topology", "1", "2",
                        "--distributed", "--device", "cpu"])
