"""``lgcnhs_tpu_torch.cli.scaling`` on CPU ranks (``--device cpu``: each
rung a gloo process group of its own), as ``tests/test_cli_aux.py:12-30``
holds the JAX ladder: one row a rung, positive rates, the first rung's
efficiency 1.0; the edge-sharded COO plans in both layouts and with the
row-sharded tables; a rung above the device count dropped and logged; the
flags JAX refuses refused."""
import pytest

from lgcnhs_tpu_torch.cli import scaling

SMALL = ["--device", "cpu", "--users", "80", "--items", "120", "--interactions", "3000",
         "--steps", "3", "--batch-size", "64"]


def test_scaling_ladder_runs():
    rows = scaling.main(SMALL + ["--meshes", "1", "2"])
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["examples_per_sec"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0 and rows[0]["speedup"] == 1.0
    assert set(rows[0]) == {"devices", "examples_per_sec", "speedup", "efficiency"}


@pytest.mark.parametrize("flags,meshes", [
    (["--chunk", "3"], [1, 2]),
    (["--coo-layout", "segment"], [2]),
    (["--coo-table-sharding"], [2]),
], ids=["bucketed", "segment", "table-sharded"])
def test_scaling_ladder_coo_runs(flags, meshes):
    rows = scaling.main(SMALL + ["--coo", *flags, "--meshes", *map(str, meshes)])
    assert [r["devices"] for r in rows] == meshes
    assert all(r["examples_per_sec"] > 0 for r in rows)
    assert rows[0]["speedup"] == 1.0


def test_scaling_drops_rungs_above_the_device_count(monkeypatch):
    warned = []
    monkeypatch.setattr(scaling, "_device_count", lambda device_type: 1)
    from lgcnhs_tpu_torch.runtime.logging import get_logger

    monkeypatch.setattr(get_logger(), "warning", lambda msg, *a: warned.append(msg % a))
    rows = scaling.main(SMALL + ["--meshes", "1", "2"])
    assert [r["devices"] for r in rows] == [1]
    assert warned == ["scaling: dropping the 2-device rung (1 cpu devices here)"]


def test_scaling_refuses_table_sharding_with_the_segment_layout():
    with pytest.raises(SystemExit):
        scaling.main(SMALL + ["--coo", "--coo-table-sharding", "--coo-layout", "segment"])
