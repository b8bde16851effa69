"""The port's Cloud Batch fan-out (C16) and Hail interop (C14/C15) against
the JAX package's: the rendered job is the same apart from the GPU fields,
the polling and submission logic give the same results and gcloud argv, the
rendered task commands run under ``/bin/sh -c`` and reproduce the JAX CLI,
and, through the fake ``hail`` of tests/test_interop_executed.py, the
exporter writes the same input and the importer reads the same table."""

import copy
import glob
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from cuking_tpu import cli as jax_cli
from cuking_tpu.cloud import batch_submit as jax_batch
from cuking_tpu.interop import mt_to_inputs as jax_mt_to_inputs
from cuking_tpu.interop import outputs_to_ht as jax_outputs_to_ht
from cuking_tpu_torch import cli
from cuking_tpu_torch.cloud import batch_submit
from cuking_tpu_torch.interop import mt_to_inputs, outputs_to_ht
from cuking_tpu_torch.parallel.submatrix import num_shards
from cuking_tpu_torch.utils.status import FailedPreconditionError, InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import random_genotypes

from tests.test_interop_executed import FakeHailTable, FakeMatrixTable, _install_fake_hail
from tests.test_torch_cli import GOLDEN_INPUT, read_output_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"jax": jax_batch, "port": batch_submit}


def _container(job):
    return job["taskGroups"][0]["taskSpec"]["runnables"][0]["container"]


def _without_accelerator_fields(job, cli_module):
    """The job without the fields that differ between a TPU VM task and an
    H100 VM task: the command's module, the container options, the machine
    type, the accelerator block, installGpuDrivers and memoryMib."""
    job = copy.deepcopy(job)
    container = _container(job)
    prefix = f"python3 -m {cli_module} "
    assert container["commands"][1].startswith(prefix)
    container["commands"][1] = container["commands"][1][len(prefix):]
    del container["options"]
    instance = job["allocationPolicy"]["instances"][0]
    instance.pop("installGpuDrivers", None)
    del instance["policy"]["machineType"], instance["policy"]["accelerators"]
    del job["taskGroups"][0]["taskSpec"]["computeResource"]["memoryMib"]
    return job


# -- Rendering -----------------------------------------------------------------


@pytest.mark.parametrize("split_factor", [1, 2, 3, 4])
def test_render_matches_jax_but_for_the_gpu_fields(split_factor):
    kw = dict(
        input_uri="gs://b/in.parquet", output_uri="gs://b/out.parquet",
        kin_threshold=0.0884, split_factor=split_factor, docker_image="img",
        requester_pays_project="proj" if split_factor % 2 else "",
        service_account="sa@proj.iam" if split_factor > 2 else "",
        extra_cli_args=("--skip_existing", "--profile_dir=gs://b/trace dir",
                        "--quiet;echo $HOME"),
    )
    port, ref = batch_submit.render_batch_job(**kw), jax_batch.render_batch_job(**kw)
    assert (_without_accelerator_fields(port, "cuking_tpu_torch.cli")
            == _without_accelerator_fields(ref, "cuking_tpu.cli"))
    group = port["taskGroups"][0]
    assert group["taskCount"] == split_factor * (split_factor + 1) // 2
    cmd = _container(port)["commands"][1]
    assert cmd.startswith("python3 -m cuking_tpu_torch.cli --input_uri=gs://b/in.parquet")
    assert ("--shard_index=$BATCH_TASK_INDEX --skip_existing "
            "'--profile_dir=gs://b/trace dir'") in cmd
    assert cmd.endswith(" '--quiet;echo $HOME'")  # one word, nothing expands
    assert _container(port)["options"] == "--gpus all --network=host"
    instance = port["allocationPolicy"]["instances"][0]
    assert instance["installGpuDrivers"] is True
    assert instance["policy"] == {
        "machineType": "a3-highgpu-1g",
        "accelerators": [{"type": "nvidia-h100-80gb", "count": 1}],
    }
    assert group["taskSpec"]["computeResource"] == {
        "cpuMilli": 12000, "memoryMib": batch_submit.DEFAULT_MEMORY_MIB}


def test_rendered_command_splits_into_the_cli_argv():
    """Under /bin/sh -c the command is the CLI's argv, each extra argument
    one word; only $BATCH_TASK_INDEX expands."""
    job = batch_submit.render_batch_job(
        input_uri="gs://b/in", output_uri="gs://b/out", kin_threshold=0.1,
        split_factor=2, docker_image="img",
        extra_cli_args=("--profile_dir=/t/a b", "--x=$HOME"))
    argv = subprocess.run(
        ["/bin/sh", "-c", "printf '%s\\n' " + _container(job)["commands"][1]],
        env={"BATCH_TASK_INDEX": "2", "HOME": "/h"}, capture_output=True, text=True,
        check=True).stdout.splitlines()
    assert argv == ["python3", "-m", "cuking_tpu_torch.cli", "--input_uri=gs://b/in",
                    "--output_uri=gs://b/out", "--kin_threshold=0.1", "--split_factor=2",
                    "--shard_index=2", "--profile_dir=/t/a b", "--x=$HOME"]


@pytest.mark.parametrize("machine_type,count", [
    ("a3-highgpu-1g", 1), ("a3-highgpu-2g", 2), ("a3-highgpu-8g", 8), ("a3-megagpu-8g", 8),
])
def test_accelerator_count_follows_the_machine_type(machine_type, count):
    job = batch_submit.render_batch_job(
        input_uri="gs://b/in", output_uri="gs://b/out", kin_threshold=0.1,
        split_factor=1, docker_image="img", machine_type=machine_type)
    policy = job["allocationPolicy"]["instances"][0]["policy"]
    assert policy["accelerators"] == [{"type": "nvidia-h100-80gb", "count": count}]


@pytest.mark.parametrize("machine_type", ["ct5lp-hightpu-1t", "n2-standard-8", "a3-highgpu-0g"])
def test_machine_type_without_gpus_is_rejected(machine_type):
    with pytest.raises(InvalidArgumentError, match="names no GPU count"):
        batch_submit.gpus_per_machine(machine_type)


def test_task_memory_holds_the_largest_shard_the_card_admits():
    """The docstring's arithmetic: planes at most 92% of the card's
    85,017,493,504 B (81,079 MiB) less the default sweep buffers, 24 GiB of
    ingest, 8 GiB for the process, under the 234 GB of a3-highgpu-1g."""
    from cuking_tpu_torch.models.king import KingConfig
    from cuking_tpu_torch.utils.hbm import sweep_buffer_bytes

    usable = int(85_017_493_504 * 0.92)
    planes_mib = (usable - sweep_buffer_bytes(KingConfig(device="cpu"))) >> 20
    need = planes_mib + 24_576 + 8_192
    assert need <= batch_submit.DEFAULT_MEMORY_MIB < need + 1024
    assert batch_submit.DEFAULT_MEMORY_MIB < 234 * 1024


# -- Submission and polling ----------------------------------------------------


def test_submit_job_runs_the_same_gcloud_command():
    calls = {}
    for name, module in MODULES.items():
        argv = []
        assert module.submit_job({"taskGroups": [name]}, location="us-east5",
                                 project="p", job_name="cuking-t",
                                 runner=argv.append) == "cuking-t"
        (cmd,) = argv
        config = [a for a in cmd if a.startswith("--config=")][0]
        with open(config.split("=", 1)[1]) as f:
            assert json.load(f) == {"taskGroups": [name]}
        calls[name] = [a for a in cmd if a != config]
    assert calls["port"] == calls["jax"] == [
        "gcloud", "batch", "jobs", "submit", "cuking-t", "--location=us-east5",
        "--project=p"]


def _poll(module, scenario):
    """Runs ``wait_for_completion`` of ``module`` against a scripted gcloud;
    returns (final state or exception type, gcloud argvs, sentinels,
    number of sleeps)."""
    responses = {
        "success": ["RUNNING", "RUNNING", "SUCCEEDED"],
        "failed": ["FAILED"],
        "cancelled": ["CANCELLED"],
        "transitional": ["RUNNING", "CANCELLATION_IN_PROGRESS",
                         "DELETION_IN_PROGRESS", "CANCELLED"],
        "deleted": ["RUNNING", "DELETION_IN_PROGRESS"],
        "describe_failure": [],
        "deadline": ["RUNNING"] * 100,
    }[scenario]
    states = iter(responses)
    argvs, sentinels, sleeps = [], [], []

    def runner(cmd):
        argvs.append(cmd)
        try:
            return json.dumps({"status": {"state": next(states)}})
        except StopIteration:
            raise subprocess.CalledProcessError(1, cmd, b"NOT_FOUND")

    try:
        outcome = module.wait_for_completion(
            "cuking-x", location="us-central1", output_uri="gs://b/out.parquet",
            runner=runner, sleep=sleeps.append, write_sentinel=sentinels.append,
            log=lambda *_: None, max_polls=7)
    except (subprocess.CalledProcessError, TimeoutError) as e:
        outcome = type(e).__name__
    return outcome, argvs, sentinels, len(sleeps)


@pytest.mark.parametrize("module", ["jax", "port"])
@pytest.mark.parametrize("scenario,outcome,polls,sentinels", [
    ("success", "SUCCEEDED", 3, ["gs://b/out.parquet/_SUCCESS"]),
    ("failed", "FAILED", 1, []),
    ("cancelled", "CANCELLED", 1, []),
    ("transitional", "CANCELLED", 4, []),
    ("deleted", "DELETED", 3, []),
    ("describe_failure", "CalledProcessError", 1, []),
    ("deadline", "TimeoutError", 7, []),
])
def test_polling_matches_jax(module, scenario, outcome, polls, sentinels):
    got = _poll(MODULES[module], scenario)
    assert got == _poll(jax_batch, scenario)
    assert got[0] == outcome
    assert len(got[1]) == polls
    assert got[1][0] == ["gcloud", "batch", "jobs", "describe", "cuking-x",
                         "--location=us-central1", "--format=json"]
    assert got[2] == sentinels


def test_default_sentinel_goes_through_the_ports_storage(tmp_path):
    out = tmp_path / "out.parquet"
    state = batch_submit.wait_for_completion(
        "cuking-x", location="us-central1", output_uri=str(out),
        runner=lambda cmd: json.dumps({"status": {"state": "SUCCEEDED"}}),
        sleep=lambda s: None, log=lambda *_: None)
    assert state == "SUCCEEDED"
    assert (out / "_SUCCESS").read_bytes() == b""


# -- The submitter's CLI -------------------------------------------------------


def test_render_only_cli_prints_the_h100_job():
    out = subprocess.run(
        [sys.executable, "-m", "cuking_tpu_torch.cloud.batch_submit", "--render-only",
         "--input-uri", "gs://b/in", "--output-uri", "gs://b/out",
         "--kin-threshold", "0.05", "--split-factor", "3", "--docker-image", "img",
         "--cuking-arg=--use_mesh"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout
    job = json.loads(out)
    assert job["taskGroups"][0]["taskCount"] == num_shards(3) == 6
    cmd = _container(job)["commands"][1]
    assert cmd.startswith("python3 -m cuking_tpu_torch.cli ")
    assert cmd.endswith("--split_factor=3 --shard_index=$BATCH_TASK_INDEX --use_mesh")
    instance = job["allocationPolicy"]["instances"][0]
    assert instance["installGpuDrivers"] is True
    assert instance["policy"]["machineType"] == "a3-highgpu-1g"
    assert instance["policy"]["accelerators"] == [{"type": "nvidia-h100-80gb", "count": 1}]


def _render_main(module, argv):
    """``module.main(argv)`` with ``--render-only``: the job it prints,
    never a submission."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert module.main([*argv, "--render-only"]) == 0
    return json.loads(buf.getvalue())


def test_reference_style_flags_match_jax():
    argv = ["--location", "us-central1", "--project-id", "my-proj",
            "--tag-name", "v1.2", "--service-account", "cuking@my-proj.iam",
            "--input-uri", "gs://b/in", "--output-uri", "gs://b/out",
            "--requester-pays-project", "my-proj", "--kin-threshold", "0.05",
            "--split-factor", "4"]
    port, ref = _render_main(batch_submit, argv), _render_main(jax_batch, argv)
    assert _container(port)["imageUri"] == (
        "us-central1-docker.pkg.dev/my-proj/images/cuking_tpu_torch:v1.2")
    assert _container(ref)["imageUri"].endswith("/images/cuking_tpu:v1.2")
    for job in (port, ref):
        _container(job)["imageUri"] = "img"
    assert (_without_accelerator_fields(port, "cuking_tpu_torch.cli")
            == _without_accelerator_fields(ref, "cuking_tpu.cli"))
    assert port["allocationPolicy"]["serviceAccount"] == {"email": "cuking@my-proj.iam"}
    ports = _render_main(batch_submit, [*argv, "--machine-type", "a3-highgpu-8g"])
    assert ports["allocationPolicy"]["instances"][0]["policy"]["accelerators"][0][
        "count"] == 8


@pytest.mark.parametrize("argv", [
    ["--input-uri", "gs://b/in"],
    ["--input-uri", "gs://b/in", "--output-uri", "o", "--kin-threshold", "0.1"],
    ["--input-uri", "i", "--output-uri", "o", "--kin-threshold", "x", "--split-factor", "1"],
])
def test_submitter_flag_errors_match_jax(argv, capsys):
    errors = []
    for module in (jax_batch, batch_submit):
        with pytest.raises(SystemExit) as e:
            module.build_parser().parse_args(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err)
    assert errors[0] == errors[1] and "error: " in errors[1]


# -- The rendered tasks, run as Batch runs them --------------------------------


def test_rendered_split2_tasks_reproduce_the_jax_cli(tmp_path):
    out, traces = tmp_path / "out.parquet", tmp_path / "traces"
    job = _render_main(batch_submit, [
        "--input-uri", GOLDEN_INPUT, "--output-uri", str(out),
        "--kin-threshold=-2.0", "--split-factor", "2", "--docker-image", "img",
        "--cuking-arg=--device=cpu", f"--cuking-arg=--profile_dir={traces}",
        "--cuking-arg=--quiet"])
    container = _container(job)
    assert container["entrypoint"] == "/bin/sh" and container["commands"][0] == "-c"
    path = os.pathsep.join([os.path.dirname(sys.executable), os.environ.get("PATH", "")])
    for k in range(job["taskGroups"][0]["taskCount"]):
        proc = subprocess.run(
            ["/bin/sh", "-c", container["commands"][1]], cwd=REPO,
            env=dict(os.environ, BATCH_TASK_INDEX=str(k), PATH=path),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(traces)) == [f"trace-part-{k:05d}.json" for k in range(3)]
    assert jax_cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri",
                         str(tmp_path / "jax"), "--kin_threshold", "-2.0",
                         "--kernel", "matmul", "--quiet"]) == 0
    ref = read_output_rows(str(tmp_path / "jax"))
    assert len(ref) == 190  # the golden fixture's rows_keep_all
    assert read_output_rows(str(out)) == ref


# -- Hail interop --------------------------------------------------------------


def test_interop_is_gated_without_hail(monkeypatch):
    monkeypatch.setitem(sys.modules, "hail", None)  # import hail -> ImportError
    with pytest.raises(FailedPreconditionError, match="mt_to_cuking_inputs requires Hail"):
        mt_to_inputs.mt_to_cuking_inputs(None, "gs://b/in.parquet")
    with pytest.raises(FailedPreconditionError, match="cuking_outputs_to_ht requires Hail"):
        outputs_to_ht.cuking_outputs_to_ht("gs://b/out.parquet")
    for module, argv in ((mt_to_inputs, ["--mt-uri", "gs://b/c.mt", "--parquet-uri", "p"]),
                         (outputs_to_ht, ["--parquet-uri", "p", "--ht-uri", "gs://b/r.ht"])):
        with pytest.raises(FailedPreconditionError, match="requires Hail"):
            module.main(argv)


@pytest.mark.parametrize("port,ref,argv", [
    (mt_to_inputs, jax_mt_to_inputs, ["--mt-uri", "x"]),
    (mt_to_inputs, jax_mt_to_inputs, ["--parquet-uri", "x", "--overwrite"]),
    (outputs_to_ht, jax_outputs_to_ht, ["--parquet-uri", "x"]),
    (outputs_to_ht, jax_outputs_to_ht, ["--ht-uri", "x", "--overwrite"]),
])
def test_interop_flag_errors_match_jax(port, ref, argv, capsys):
    errors = []
    for module in (ref, port):
        with pytest.raises(SystemExit) as e:
            module.main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err)
    assert errors[0] == errors[1] and "required" in errors[1]


def _table_rows(uri):
    files = sorted(glob.glob(os.path.join(uri, "*.parquet")))
    table = pa.concat_tables([pq.read_table(f) for f in files])
    return [os.path.basename(f) for f in files], sorted(zip(*table.to_pydict().values()))


@pytest.fixture
def fake_cohort():
    g = random_genotypes(40, 500, missing_rate=0.12, seed=23, num_related_pairs=3)
    return np.ascontiguousarray(g.T), [f"HG{k:05d}" for k in range(40)]


def test_exporter_and_importer_match_jax_through_the_cli(tmp_path, monkeypatch, fake_cohort):
    geno, ids = fake_cohort
    _install_fake_hail(monkeypatch)
    exported = {}
    for name, module in (("jax", jax_mt_to_inputs), ("port", mt_to_inputs)):
        uri = str(tmp_path / f"{name}_in.parquet")
        module.mt_to_cuking_inputs(FakeMatrixTable(geno, ids), uri)
        with open(os.path.join(uri, "metadata.json")) as f:
            exported[name] = (json.load(f), _table_rows(uri))
    assert exported["port"] == exported["jax"]
    assert exported["port"][0] == {"num_sites": 500, "samples": ids}

    # The exported input through each CLI, then each importer on its partitions.
    common = ["--input_uri", str(tmp_path / "port_in.parquet"), "--kin_threshold",
              "-2.0", "--split_factor", "2", "--quiet"]
    for shard in range(3):
        argv = [*common, "--shard_index", str(shard)]
        assert cli.main([*argv, "--output_uri", str(tmp_path / "port_out"),
                         "--device", "cpu"]) == 0
        assert jax_cli.main([*argv, "--output_uri", str(tmp_path / "jax_out"),
                             "--kernel", "matmul"]) == 0
    port_rows = read_output_rows(str(tmp_path / "port_out"))
    assert len(port_rows) == 40 * 39 // 2
    assert port_rows == read_output_rows(str(tmp_path / "jax_out"))
    port_ht = outputs_to_ht.cuking_outputs_to_ht(str(tmp_path / "port_out"))
    jax_ht = jax_outputs_to_ht.cuking_outputs_to_ht(str(tmp_path / "jax_out"))
    assert port_ht.key == jax_ht.key == ("i", "j")
    assert port_ht.table.num_rows == 40 * 39 // 2
    assert port_ht.table.equals(jax_ht.table)


def test_interop_mains_match_jax(tmp_path, monkeypatch, fake_cohort):
    """Both modules' command lines: --mt-uri/--parquet-uri/--overwrite and
    --parquet-uri/--ht-uri/--overwrite reach the same calls."""
    geno, ids = fake_cohort
    hl = _install_fake_hail(monkeypatch)
    writes = []
    monkeypatch.setattr(FakeHailTable, "write",
                        lambda self, uri, overwrite=False: writes.append(
                            (uri, overwrite, self.key, self.table.num_rows)),
                        raising=False)
    results = {}
    for name, modules in (("jax", (jax_mt_to_inputs, jax_outputs_to_ht)),
                          ("port", (mt_to_inputs, outputs_to_ht))):
        exporter, importer = modules
        uri = str(tmp_path / f"{name}.parquet")
        hl.read_matrix_table = lambda mt_uri: FakeMatrixTable(geno, ids)
        assert exporter.main(["--mt-uri", "gs://b/c.mt", "--parquet-uri", uri]) == 0
        with pytest.raises(FileExistsError):
            exporter.main(["--mt-uri", "gs://b/c.mt", "--parquet-uri", uri])
        assert exporter.main(["--mt-uri", "gs://b/c.mt", "--parquet-uri", uri,
                              "--overwrite"]) == 0
        results[name] = _table_rows(uri)
        # The importer reads the CLI's partitions, here the golden fixture's.
        out = str(tmp_path / f"{name}_out")
        assert cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri", out,
                         "--device", "cpu", "--kin_threshold", "-2.0", "--quiet"]) == 0
        assert importer.main(["--parquet-uri", out, "--ht-uri", "gs://b/r.ht",
                              "--overwrite"]) == 0
    assert results["port"] == results["jax"]
    assert writes[0] == writes[1] == ("gs://b/r.ht", True, ("i", "j"), 190)
