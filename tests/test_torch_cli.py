"""The port's CLI (python -m cuking_tpu_torch.cli --device cpu) end to end:
bit-exact with the committed golden fixture (as tests/test_golden.py holds
the JAX CLI), equal to the JAX CLI on a synthetic input, with the same flag
validation errors; and the default --device cuda fails cleanly without a
GPU."""

import json
import os
import struct

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from cuking_tpu import cli as jax_cli
from cuking_tpu_torch import cli
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.utils.synthetic import random_genotypes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_INPUT = os.path.join(GOLDEN, "input.parquet")


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        return json.load(f)


def read_output_rows(output_uri):
    rows = []
    for f in Storage().list_parquet_files(output_uri):
        t = pq.read_table(f)
        kin = np.asarray(t.column("kin").to_numpy(), np.float32)
        for k in range(t.num_rows):
            rows.append({
                "i": t.column("i")[k].as_py(),
                "j": t.column("j")[k].as_py(),
                "kin_bits": struct.unpack("<I", kin[k].tobytes())[0],
                "ibs0": t.column("ibs0")[k].as_py(),
                "ibs1": t.column("ibs1")[k].as_py(),
                "ibs2": t.column("ibs2")[k].as_py(),
            })
    return sorted(rows, key=lambda r: (r["i"], r["j"]))


@pytest.mark.parametrize("rows_key,threshold", [
    ("rows_default_threshold", 0.0884),
    ("rows_keep_all", -2.0),
])
def test_cli_matches_golden(tmp_path, expected, rows_key, threshold):
    out = str(tmp_path / "out.parquet")
    rc = cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri", out,
                   "--kin_threshold", str(threshold), "--device", "cpu",
                   "--quiet"])
    assert rc == 0
    exp = sorted(expected[rows_key], key=lambda r: (r["i"], r["j"]))
    assert read_output_rows(out) == exp


def test_sharded_cli_matches_golden(tmp_path, expected):
    out = str(tmp_path / "out-sharded.parquet")
    for shard in range(3):
        rc = cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri", out,
                       "--kin_threshold", "-2.0", "--split_factor", "2",
                       "--shard_index", str(shard), "--device", "cpu", "--quiet"])
        assert rc == 0
    exp = sorted(expected["rows_keep_all"], key=lambda r: (r["i"], r["j"]))
    assert read_output_rows(out) == exp


@pytest.mark.parametrize("threshold", ["0.0884", "-2.0"])
def test_cli_matches_jax_cli(tmp_path, threshold):
    g = random_genotypes(200, 3000, missing_rate=0.05, seed=8, num_related_pairs=4)
    inp = str(tmp_path / "in.parquet")
    write_synthetic_input(Storage(), inp, g)
    common = ["--input_uri", inp, "--kin_threshold", threshold, "--quiet"]
    assert cli.main([*common, "--output_uri", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    assert jax_cli.main([*common, "--output_uri", str(tmp_path / "jax"),
                         "--kernel", "matmul"]) == 0
    port, ref = read_output_rows(str(tmp_path / "port")), read_output_rows(str(tmp_path / "jax"))
    assert len(ref) >= 4
    assert port == ref


@pytest.mark.parametrize("argv", [
    [],
    ["--input_uri", "x"],
    ["--input_uri", "x", "--output_uri", "y", "--num_reader_threads", "0"],
    ["--input_uri", "x", "--output_uri", "y", "--split_factor", "0"],
    ["--input_uri", "x", "--output_uri", "y", "--split_factor", "2",
     "--shard_index", "3"],
    ["--input_uri", "x", "--output_uri", "y", "--shard_index", "-1"],
])
def test_flag_validation_matches_jax(argv, capsys):
    assert jax_cli.main(argv) == 1
    ref = capsys.readouterr().err
    assert cli.main([*argv, "--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref
    assert "INVALID_ARGUMENT" in ref


def test_cli_errors_of_the_port(tmp_path, capsys, monkeypatch):
    """The default --device cuda without a GPU, --kernel cuda on the CPU,
    and a shard that does not fit the device all exit 1 before any work."""
    args = ["--input_uri", GOLDEN_INPUT, "--output_uri", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        assert cli.main(args) == 1
        assert "FAILED_PRECONDITION: --device cuda needs a CUDA device" in capsys.readouterr().err
    assert cli.main([*args, "--device", "cpu", "--kernel", "cuda"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    monkeypatch.setenv("CUKING_HBM_BYTES_LIMIT", "1000")
    assert cli.main([*args, "--device", "cpu"]) == 1
    assert "no --split_factor can relieve it" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")


def test_cli_skip_existing(tmp_path, capsys):
    out = str(tmp_path / "out")
    args = ["--input_uri", GOLDEN_INPUT, "--output_uri", out, "--device", "cpu"]
    assert cli.main([*args, "--quiet"]) == 0
    assert cli.main([*args, "--skip_existing"]) == 0
    assert "already exists; skipping" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--tile_i=256", "--indexed_panels",
                                  "--no-indexed_panels", "--kernel=pallas"])
def test_unported_flags_are_rejected(flag):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(["--input_uri", "x", flag])
    assert e.value.code == 2


@pytest.mark.parametrize("threshold", ["0.0884", "-2.0"])
def test_popcount_cli_matches_jax_cli_on_golden(tmp_path, threshold):
    common = ["--input_uri", GOLDEN_INPUT, "--kin_threshold", threshold,
              "--kernel", "popcount", "--quiet"]
    assert cli.main([*common, "--output_uri", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    assert jax_cli.main([*common, "--output_uri", str(tmp_path / "jax")]) == 0
    port, ref = read_output_rows(str(tmp_path / "port")), read_output_rows(str(tmp_path / "jax"))
    assert len(ref) > 0
    assert port == ref


@pytest.mark.parametrize("mesh", [[], ["--use_mesh", "--device", "cpu,cpu"]],
                         ids=["engine", "mesh"])
def test_profile_dir_writes_a_trace_per_partition(tmp_path, expected, mesh):
    traces = tmp_path / "traces"
    out = str(tmp_path / "out")
    for shard in range(3):
        rc = cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri", out,
                       "--kin_threshold", "-2.0", "--split_factor", "2",
                       "--shard_index", str(shard), "--device", "cpu",
                       "--profile_dir", str(traces), "--quiet", *mesh])
        assert rc == 0
    assert sorted(os.listdir(traces)) == [f"trace-part-{k:05d}.json" for k in range(3)]
    for name in os.listdir(traces):
        with open(traces / name) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events), name
    exp = sorted(expected["rows_keep_all"], key=lambda r: (r["i"], r["j"]))
    assert read_output_rows(out) == exp


def test_cuda_kernel_reads_panels_through_the_indexed_entry():
    """The cuda kernel always takes the indexed entry (no card needed to
    resolve it); the plain kernels slice their panels."""
    from cuking_tpu_torch.models.king import KingConfig, resolve_indexed_kernel
    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed

    assert resolve_indexed_kernel(KingConfig(device="cuda")) is panel_counts_cuda_indexed
    assert resolve_indexed_kernel(KingConfig(kernel="cuda", device="cuda")) is panel_counts_cuda_indexed
    assert resolve_indexed_kernel(KingConfig(device="cpu")) is None
    assert resolve_indexed_kernel(KingConfig(kernel="popcount", device="cuda")) is None
