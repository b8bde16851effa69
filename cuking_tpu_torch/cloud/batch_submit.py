"""Port of ``cuking_tpu/cloud/batch_submit.py``: shard fan-out via GCP Cloud
Batch on single-H100 VMs (C16).

Mirror of the reference's cloud_batch_submit.py:36-130, which ran one A100
per task (``a2-highgpu-1g``); here one H100 per task (``a3-highgpu-1g`` by
default).  Renders a Batch job JSON with ``taskCount = k(k+1)/2`` — one task
per upper-triangular shard — where every task runs the cuking_tpu_torch
container with ``--shard_index=$BATCH_TASK_INDEX``, submits it with ``gcloud
batch jobs submit``, and (optionally) polls job state every 5 minutes until
``SUCCEEDED``, then writes a ``_SUCCESS`` sentinel into the output directory
(cloud_batch_submit.py:103-130).

Every shard is idempotent and rewrites only its own ``part-%05d`` partition,
so failed tasks can simply be resubmitted (README.md:102 semantics).

All gcloud/filesystem effects go through injectable callables so the JSON
rendering and the polling logic are unit-testable without GCP.
"""

from __future__ import annotations

import argparse
import json
import re
import shlex
import subprocess
import sys
import tempfile
import time
import uuid

from cuking_tpu_torch.parallel.submatrix import num_shards
from cuking_tpu_torch.utils.status import InvalidArgumentError

POLL_INTERVAL_S = 300  # cloud_batch_submit.py:127
MAX_RUN_DURATION_S = 36000  # per-task budget (cloud_batch_submit.py:53)
DEFAULT_MACHINE_TYPE = "a3-highgpu-1g"  # 1 H100 80GB, 26 vCPU, 234 GB
GPU_TYPE = "nvidia-h100-80gb"

# Host memory per task, in MiB: the largest shard's planes plus ingest's
# working set plus the process itself.
#
# * Planes.  ``utils/hbm.check_engine_fit`` admits a shard whose planes,
#   result buffers and per-step transients fit in 92% of the card's free
#   memory.  An H100 80GB HBM3 has 81,079 MiB (``total_memory`` 85,017,493,504
#   B), and free memory never exceeds it, so at most 74,592 MiB; the default
#   buffers take 496 MiB (10,485,760 result slots x 24 B, plus 256 B x 1024²
#   of transients), leaving at most 74,096 MiB of planes.  A task rendered
#   here runs one engine on its card, so ingest builds the planes there
#   (``ops/king_scatter.py``) and the host holds none, only a 32 MiB pinned
#   staging pool: for such a task this term is headroom.  It is kept for
#   the runs that hold host planes (``PanelStorage.planes``) while they
#   ingest and upload them without a second host copy: ``--use_mesh`` and
#   ``--distributed``, and the tools.  On the card (NVIDIA H100 80GB HBM3,
#   700.00 W) a fresh process with host planes
#   (``tools/torch_shard_at_scale.py``) was admitted 308,224 x 1,000,000,
#   73,491 MiB of planes, and peaked at 78,378 MiB of host RSS; in
#   ``chip_smoke.py`` phase 13b the RSS did not grow across the upload.
# * Ingest.  ``io/parquet_ingest.py`` keeps at most 2 files per decode
#   worker in flight, one worker per CPU the task may run on: 52 files on
#   the 26 vCPUs of ``a3-highgpu-1g``.  A file costs its bytes plus ~52 B
#   per entry (20 B decoded, 20 B after the shard filter, 12 B of packer
#   indices), so 24,576 MiB holds 52 files of up to ~9M entries.  On the
#   card's host (NVIDIA H100 80GB HBM3, 700.00 W; cell O of
#   ``tools/torch_cli_at_scale.py``: 150,000 x 1,000,000, files of ~9.0M
#   entries) ingest alone peaked at 44,175 MiB with 4 decoders and 47,485
#   with 8 (means of three and eight runs): 827 MiB per decoder, 21,514
#   MiB at 26, a 12% margin under this term.
# * The process: Python, torch and the CUDA runtime, and the result set
#   with its sort (up to 10,485,760 rows of 24 B, a few copies): 8,192 MiB.
#   The whole cell O task peaked 12,197-12,787 MiB beside its planes on 8
#   decoders, so 5,577-6,167 MiB beside the decoders' share, and a
#   26-decoder task ~27,092-27,682 MiB, inside these two terms' 32,768.
#
# 74,096 + 24,576 + 8,192 = 106,864, rounded up to 105 GiB = 107,520 MiB,
# under the 234 GB of ``a3-highgpu-1g``.  The reference asked 85 GiB
# (87,040 MiB) of ``a2-highgpu-1g`` for a 40 GB A100.
DEFAULT_MEMORY_MIB = 107_520


def gpus_per_machine(machine_type: str) -> int:
    """The H100 count of a GPU machine type, from its ``-<N>g`` suffix
    (``a3-highgpu-1g`` → 1, ``a3-highgpu-8g`` → 8)."""
    m = re.fullmatch(r".+-(\d+)g", machine_type)
    if not m or int(m.group(1)) < 1:
        raise InvalidArgumentError(
            f"Machine type {machine_type!r} names no GPU count (expected a "
            "'-<N>g' suffix, e.g. a3-highgpu-1g)"
        )
    return int(m.group(1))


def render_batch_job(
    *,
    input_uri: str,
    output_uri: str,
    kin_threshold: float,
    split_factor: int,
    docker_image: str,
    requester_pays_project: str = "",
    service_account: str = "",
    machine_type: str = DEFAULT_MACHINE_TYPE,
    cpu_milli: int = 12000,
    memory_mib: int = DEFAULT_MEMORY_MIB,
    max_run_duration_s: int = 36000,
    extra_cli_args: tuple[str, ...] = (),
) -> dict:
    """Renders the Cloud Batch job spec (cloud_batch_submit.py:36-77).

    The reference's 12 vCPU and 36,000 s budget per shard, with host memory
    sized for one 80 GB card (``DEFAULT_MEMORY_MIB``).  Every task VM gets
    the machine type's H100s and Batch installs their driver; the container
    sees them through ``--gpus all``, as the reference's ``docker run --gpus
    all`` did.

    ``extra_cli_args`` are appended to every task's cuking_tpu_torch command
    — e.g. ``("--use_mesh",)`` to sweep each shard over all cards of a
    multi-GPU task VM (--use_mesh composes with --split_factor), or
    ``("--skip_existing",)`` for idempotent resubmits.  Each argument is
    shell-quoted: it reaches the task's argv as ONE word, with no shell
    expansion inside it (the command runs under ``/bin/sh -c``).
    """
    cuking_cmd = (
        "python3 -m cuking_tpu_torch.cli"
        f" --input_uri={input_uri}"
        f" --output_uri={output_uri}"
        + (
            f" --requester_pays_project={requester_pays_project}"
            if requester_pays_project
            else ""
        )
        + f" --kin_threshold={kin_threshold}"
        + f" --split_factor={split_factor}"
        + " --shard_index=$BATCH_TASK_INDEX"
        + "".join(f" {shlex.quote(a)}" for a in extra_cli_args)
    )
    job = {
        "taskGroups": [
            {
                "taskSpec": {
                    "runnables": [
                        {
                            "container": {
                                "imageUri": docker_image,
                                "options": "--gpus all --network=host",
                                "entrypoint": "/bin/sh",
                                "commands": ["-c", cuking_cmd],
                            }
                        }
                    ],
                    "computeResource": {
                        "cpuMilli": cpu_milli,
                        "memoryMib": memory_mib,
                    },
                    "maxRunDuration": f"{max_run_duration_s}s",
                },
                # One independent task per upper-triangular shard
                # (cloud_batch_submit.py:73).
                "taskCount": num_shards(split_factor),
                "taskCountPerNode": 1,
            }
        ],
        "allocationPolicy": {
            "instances": [
                {
                    "installGpuDrivers": True,
                    "policy": {
                        "machineType": machine_type,
                        "accelerators": [
                            {
                                "type": GPU_TYPE,
                                "count": gpus_per_machine(machine_type),
                            }
                        ],
                    },
                }
            ]
        },
        "logsPolicy": {"destination": "CLOUD_LOGGING"},
    }
    if service_account:
        # Must match the account the VM instances run as
        # (cloud_batch_submit.py:19-20).
        job["allocationPolicy"]["serviceAccount"] = {"email": service_account}
    return job


def submit_job(
    job: dict,
    *,
    location: str,
    project: str = "",
    job_name: str | None = None,
    runner=subprocess.check_call,
) -> str:
    """Writes the job JSON and submits it via gcloud
    (cloud_batch_submit.py:75-91); returns the job name."""
    job_name = job_name or f"cuking-{uuid.uuid4().hex[:8]}"
    with tempfile.NamedTemporaryFile(
        "w", suffix=".json", prefix="batch_job_", delete=False
    ) as f:
        json.dump(job, f, indent=2)
        config_path = f.name
    cmd = [
        "gcloud", "batch", "jobs", "submit", job_name,
        f"--location={location}", f"--config={config_path}",
    ]
    if project:
        cmd.append(f"--project={project}")
    runner(cmd)
    return job_name


def wait_for_completion(
    job_name: str,
    *,
    location: str,
    output_uri: str,
    runner=subprocess.check_output,
    sleep=time.sleep,
    write_sentinel=None,
    poll_interval_s: int = POLL_INTERVAL_S,
    log=print,
    max_polls: int | None = None,
    max_run_duration_s: int = MAX_RUN_DURATION_S,
) -> str:
    """Polls job state every 5 minutes (cloud_batch_submit.py:103-130).

    On ``SUCCEEDED`` writes an empty ``_SUCCESS`` sentinel object into the
    output directory (the merge-ready signal downstream pipelines gate on)
    and returns the final state.  Any other non-active, non-transitional
    state (FAILED, CANCELLED, ...) returns without the sentinel — the
    reference script only knows SUCCEEDED/FAILED, but library callers must
    not poll a cancelled job forever.  ``*_IN_PROGRESS`` states (e.g.
    CANCELLATION_IN_PROGRESS) are transitional, not terminal: polling
    continues until the control plane reports the state they resolve to, so
    callers always receive a final state.  ``max_polls`` bounds an unattended
    caller even if the control plane keeps reporting an active state; its
    default budgets the job's maxRunDuration (pass ``max_run_duration_s`` to
    match a non-default ``render_batch_job``) plus 24 h of queue-time slack
    — Batch's maxRunDuration excludes time spent QUEUED.
    """
    if write_sentinel is None:

        def write_sentinel(uri: str) -> None:
            from cuking_tpu_torch.io.uri import Storage

            with Storage().open_write(uri) as f:
                f.write(b"")

    active_states = {
        "", "STATE_UNSPECIFIED", "QUEUED", "SCHEDULED", "RUNNING",
        # Transitional: these resolve to CANCELLED / deletion shortly; keep
        # polling so the caller gets the true final state.
        "CANCELLATION_IN_PROGRESS", "DELETION_IN_PROGRESS",
    }
    if max_polls is None:
        max_polls = (max_run_duration_s + 24 * 3600) // max(poll_interval_s, 1)
    last_state = ""
    for _ in range(max_polls):
        try:
            described = runner(
                [
                    "gcloud", "batch", "jobs", "describe", job_name,
                    f"--location={location}", "--format=json",
                ]
            )
        except Exception:
            # A deletion in progress ends with the job RESOURCE disappearing:
            # the next describe exits non-zero (NOT_FOUND).  That IS the
            # final outcome for deletion — report the transition we saw
            # rather than crashing the submitter.  Failures with no deletion
            # context are real errors and propagate.
            if last_state == "DELETION_IN_PROGRESS":
                log(f"Job {job_name} no longer exists (deleted).")
                return "DELETED"
            raise
        state = json.loads(described).get("status", {}).get("state", "")
        last_state = state
        log(f"Job {job_name} state: {state}")
        if state == "SUCCEEDED":
            write_sentinel(f"{output_uri}/_SUCCESS")
            return state
        if state not in active_states:
            return state
        sleep(poll_interval_s)
    raise TimeoutError(
        f"Job {job_name} still not terminal after {max_polls} polls"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=(
            "Fan a sharded cuking_tpu_torch run out over independent "
            "single-GPU Cloud Batch tasks."
        )
    )
    # Flag names follow the reference submitter (cloud_batch_submit.py:11-34)
    # so existing pipelines swap in directly; --docker-image is the escape
    # hatch when the image isn't at the conventional registry path.
    p.add_argument("--location", default="us-central1",
                   help="GCP region for the Batch job and GPU VMs")
    p.add_argument("--project-id", default="",
                   help="GCP project (defaults to the gcloud config project)")
    p.add_argument("--tag-name", default="latest",
                   help="Image tag in the project's Artifact Registry "
                        "'images' repository (see Cloud Build substitutions)")
    p.add_argument("--service-account", default="",
                   help="Service account to run the job as (should match "
                        "the VM instance template's)")
    p.add_argument("--input-uri", required=True,
                   help="gs:// directory with input Parquet + metadata.json")
    p.add_argument("--output-uri", required=True,
                   help="gs:// directory for the result partitions")
    p.add_argument("--kin-threshold", type=float, required=True,
                   help="Only store kinship coefficients above this")
    p.add_argument("--split-factor", type=int, required=True,
                   help="k: the matrix splits into k(k+1)/2 shards/tasks")
    p.add_argument("--requester-pays-project", default="",
                   help="User project for Requester Pays buckets")
    p.add_argument("--docker-image", default="",
                   help="Full image URI (overrides --project-id/--tag-name)")
    p.add_argument("--machine-type", default=DEFAULT_MACHINE_TYPE,
                   help="GPU VM machine type; its '-<N>g' suffix gives the "
                        "H100s per task (one shard per task)")
    p.add_argument("--cuking-arg", action="append", default=[],
                   dest="cuking_args", metavar="ARG",
                   help="Extra cuking_tpu_torch CLI flag appended to every "
                        "task verbatim (repeatable) — e.g. "
                        "--cuking-arg=--use_mesh on a multi-GPU machine "
                        "type, or --cuking-arg=--skip_existing for "
                        "idempotent resubmits")
    p.add_argument("--render-only", action="store_true",
                   help="Print the Batch job JSON and exit (no submission)")
    p.add_argument("--write-success-file", "--wait", dest="wait",
                   action="store_true",
                   help="Poll until the job completes; on success write a "
                        "_SUCCESS file to the output directory")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    docker_image = args.docker_image or (
        f"{args.location}-docker.pkg.dev/{args.project_id}/images/"
        f"cuking_tpu_torch:{args.tag_name}"
    )
    job = render_batch_job(
        input_uri=args.input_uri,
        output_uri=args.output_uri,
        kin_threshold=args.kin_threshold,
        split_factor=args.split_factor,
        requester_pays_project=args.requester_pays_project,
        service_account=args.service_account,
        docker_image=docker_image,
        machine_type=args.machine_type,
        extra_cli_args=tuple(args.cuking_args),
    )
    if args.render_only:
        print(json.dumps(job, indent=2))
        return 0
    job_name = submit_job(job, location=args.location, project=args.project_id)
    print(f"Submitted job: {job_name}")
    if args.wait:
        state = wait_for_completion(
            job_name, location=args.location, output_uri=args.output_uri
        )
        if state != "SUCCEEDED":
            print(f"Job {job_name} finished in state {state}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
