"""Job-farm queueing for GPU training runs (the GPU counterpart of
``sky_embeddings_tpu/cluster/queue_tpu.py``, reference ``cc/queue_cc.py``:
Slurm/PBS cluster database + chained submission, ``queue_cc.py:43-130,
355-408``). The elasticity model is JAX's: training runs checkpoint on a
wall clock and resume unconditionally, so a long run is submitted as N
chained short allocations, each continuing from the last checkpoint.

A job runs on ``hosts`` GPU hosts of ``gpus`` GPUs each, one process per
GPU (JAX's ``v4-32`` pod runs one process on each of its hosts with
``--worker=all``; the CUDA idiom is one a GPU). The job script is written
once and runs once on every host: it starts ``gpus`` copies of the
command, local rank l with ``SKY_DISTRIBUTED=1``,
``SKY_COORDINATOR_ADDRESS``, ``SKY_NUM_PROCESSES = hosts x gpus`` and
``SKY_PROCESS_ID = node_rank x gpus + l`` (what
``parallel/distributed.initialize_from_env`` reads; ``rank_device`` puts
global rank r on ``cuda:<r % gpus>``, its local rank), waits for every
rank and exits non-zero when any rank fails, after stopping the others, so
that a chain never continues past a failed run. On one host the
coordinator is ``127.0.0.1`` on a port free when the job starts. Across
hosts it is host 0's address on a port every host computes alike
(``SKY_COORDINATOR_PORT`` when set, else one fixed by the job's name), and
the node rank and host 0 come from the backend: Slurm's ``SLURM_NODEID``
and the first name of ``$SLURM_JOB_NODELIST``, or ``SKY_NODE_RANK`` and
``SKY_COORDINATOR_HOST``, which the gcloud driver exports on each VM. A
config with ``[TRAINING] tensor_parallel = tp`` (MIM, predictor or I-JEPA)
needs nothing more: its trainer lays the same ranks out as a (ranks / tp,
tp) mesh itself (``parallel/mesh.py``), consecutive ranks, so consecutive
GPUs of one host, forming each model group where tp divides ``gpus``.

Three backends:

* ``slurm``  — ``sbatch --nodes=<hosts> --gres=gpu:<N>`` with
  ``--dependency=afterany:<prev>`` chaining; across hosts one task a node,
  the script under ``srun --kill-on-bad-exit=1`` so that a failed host
  ends the job;
* ``gcloud`` — writes a driver script that creates ``hosts`` GPU VMs
  (``gcloud compute instances create``, an A3 machine of the accelerator's
  GPU count) and runs the chain over ``gcloud compute ssh``, every VM's
  script at once, a failed one stopping the chain and the others' scripts
  (``pkill`` of the job's marker on every VM; the script stops its ranks);
* ``local``  — a sequential chain on this host in a background session
  (single-host GPU machines, and testing the tooling); :meth:`JobQueue.wait`
  waits for it. It refuses an accelerator of several hosts.

Job scripts are written to ``scripts/todo/`` and moved to ``scripts/done/``
on submission, mirroring the reference's bookkeeping.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

from sky_embeddings_tpu_torch.parallel.distributed import ENV_COORD, ENV_FLAG, ENV_NPROC, ENV_PID

# Accelerator database: GPU hosts by count and GPUs a host (the counterpart
# of the reference's per-cluster GPU/core/memory table, queue_cc.py:43-130,
# and of queue_tpu.py's v4-32 pod), with the GCE machine type of one host.
ACCELERATORS = {
    "h100-1": dict(hosts=1, gpus=1, machine="a3-highgpu-1g"),
    "h100-2": dict(hosts=1, gpus=2, machine="a3-highgpu-2g"),
    "h100-4": dict(hosts=1, gpus=4, machine="a3-highgpu-4g"),
    "h100-8": dict(hosts=1, gpus=8, machine="a3-highgpu-8g"),
    "h100-16": dict(hosts=2, gpus=8, machine="a3-highgpu-8g"),
    "h100-32": dict(hosts=4, gpus=8, machine="a3-highgpu-8g"),
}
MULTI_HOST_BACKENDS = ("slurm", "gcloud")

# the variables the gcloud driver exports on each VM of a job across hosts,
# and the coordinator port's override
ENV_NODE_RANK = "SKY_NODE_RANK"
ENV_COORD_HOST = "SKY_COORDINATOR_HOST"
ENV_COORD_PORT = "SKY_COORDINATOR_PORT"

# a free localhost port for the ranks' coordinator, picked when the job starts
_FREE_PORT = ("python3 -c 'import socket; s = socket.socket(); s.bind((\"127.0.0.1\", 0)); "
              "print(s.getsockname()[1])'")


def job_port(name: str) -> int:
    """The coordinator port of a job across hosts: every host computes it
    alike from the job's name, in 20000..39999."""
    return 20000 + zlib.crc32(name.encode()) % 20000


@dataclass
class JobSpec:
    name: str
    command: str                      # the training command, run once per GPU
    accelerator: str = "h100-8"
    time_limit: str = "03:00:00"      # per-allocation wall clock
    num_runs: int = 7                 # chained resumes (ref default, launch_pretraining.py:23-25)
    env: dict = field(default_factory=dict)
    setup_lines: list = field(default_factory=list)  # e.g. data staging


class JobQueue:
    def __init__(self, scripts_dir: str, backend: str = "local"):
        if backend not in ("local", "slurm", "gcloud"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.todo_dir = os.path.join(scripts_dir, "todo")
        self.done_dir = os.path.join(scripts_dir, "done")
        self.stdout_dir = os.path.join(scripts_dir, "stdout")
        for d in (self.todo_dir, self.done_dir, self.stdout_dir):
            os.makedirs(d, exist_ok=True)
        self._local: list[subprocess.Popen] = []

    # ------------------------------------------------------------------
    def write_script(self, spec: JobSpec) -> str:
        """Write the job script to scripts/todo/<name>.sh: the environment
        and setup lines, then one background copy of the command per GPU
        of this host with its rank's ``SKY_*`` variables, each in its own
        process group (``set -m``) so that the first failed rank's peers can
        be stopped; the script's exit code is 0 only when every rank's is.
        Across hosts the script first reads its node rank and host 0's
        address from the backend (module docstring)."""
        acc = ACCELERATORS[spec.accelerator]
        hosts, n = acc["hosts"], acc["gpus"]
        lines = ["#!/bin/bash", "set -e"]
        for k, v in spec.env.items():
            lines.append(f"export {k}={v}")
        lines.extend(spec.setup_lines)
        if hosts == 1:
            lines += [
                "# one process per GPU: rank r on cuda:r, through the SKY_* contract",
                "set -m",
                f"SKY_PORT=$({_FREE_PORT})",
                "pids=()",
                f"for RANK in $(seq 0 {n - 1}); do",
                "  (",
                f"    export {ENV_FLAG}=1 {ENV_COORD}=127.0.0.1:$SKY_PORT {ENV_NPROC}={n} "
                f"{ENV_PID}=$RANK",
                f"    {spec.command}",
                "  ) &",
            ]
        else:
            lines += [
                f"# {hosts} hosts x {n} GPUs, this script on each: the node rank and host 0",
                "# from Slurm (srun, one task a node) or from the gcloud driver",
                'if [ -n "${SLURM_NODEID:-}" ]; then',
                "  NODE_RANK=$SLURM_NODEID",
                '  COORD_HOST=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)',
                "else",
                f"  NODE_RANK=${{{ENV_NODE_RANK}:?the node rank (0..{hosts - 1}) of this host}}",
                f"  COORD_HOST=${{{ENV_COORD_HOST}:?the address of host 0}}",
                "fi",
                f"SKY_PORT=${{{ENV_COORD_PORT}:-{job_port(spec.name)}}}",
                "# one process per GPU: global rank NODE_RANK * GPUs + r on cuda:r; a",
                "# TERM or HUP (a peer host failed) stops every rank of this host",
                "set -m",
                "pids=()",
                """trap 'for pid in "${pids[@]}"; do kill -- -"$pid" 2>/dev/null || true; done; """
                """exit 143' TERM HUP""",
                f"for RANK in $(seq 0 {n - 1}); do",
                "  (",
                f"    export {ENV_FLAG}=1 {ENV_COORD}=$COORD_HOST:$SKY_PORT "
                f"{ENV_NPROC}={hosts * n} {ENV_PID}=$((NODE_RANK * {n} + RANK))",
                f"    {spec.command}",
                "  ) &",
            ]
        lines += [
            "  pids+=($!)",
            "done",
            "status=0",
            'for _ in "${pids[@]}"; do',
            "  if ! wait -n; then",
            "    status=1",
            '    for pid in "${pids[@]}"; do kill -- -"$pid" 2>/dev/null || true; done',
            "  fi",
            "done",
            "exit $status",
        ]
        path = os.path.join(self.todo_dir, f"{spec.name}.sh")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.chmod(path, 0o755)
        return path

    # ------------------------------------------------------------------
    def _slurm_command(self, spec: JobSpec, script: str, dependency: Optional[str]) -> list[str]:
        acc = ACCELERATORS[spec.accelerator]
        cmd = [
            "sbatch",
            f"--job-name={spec.name}",
            f"--time={spec.time_limit}",
            f"--output={self.stdout_dir}/%x-%j.out",
            f"--nodes={acc['hosts']}",
        ]
        if acc["hosts"] > 1:
            cmd.append("--ntasks-per-node=1")
        cmd.append(f"--gres=gpu:{acc['gpus']}")
        if dependency:
            # afterany: continue the chain even if the previous run was
            # preempted/timed out (ref queue_cc.py:379-408)
            cmd.append(f"--dependency=afterany:{dependency}")
        if acc["hosts"] > 1:
            # the batch script runs on the first node: srun runs the job
            # script once a node, and ends every node's when one fails
            cmd.append(f"--wrap=srun --kill-on-bad-exit=1 bash {script}")
        else:
            cmd.append(script)
        return cmd

    def _gcloud_script(self, spec: JobSpec, script: str) -> str:
        """Emit a driver script that provisions the GPU VMs and runs the chain."""
        acc = ACCELERATORS[spec.accelerator]
        driver = os.path.join(self.done_dir, f"{spec.name}_gcloud.sh")
        if acc["hosts"] == 1:
            body = f"""#!/bin/bash
# Provision a GPU VM ({acc["gpus"]} x H100) and run {spec.num_runs} chained allocations of {spec.name}.
set -e
VM_NAME={spec.name}-gpu
ZONE=${{ZONE:-us-central1-a}}
gcloud compute instances create $VM_NAME --zone=$ZONE \\
  --machine-type={acc["machine"]} --maintenance-policy=TERMINATE \\
  --image-family=pytorch-latest-gpu --image-project=deeplearning-platform-release \\
  --boot-disk-size=200GB --metadata=install-nvidia-driver=True || true
for RUN in $(seq 1 {spec.num_runs}); do
  echo "=== chained run $RUN/{spec.num_runs} ==="
  # the job script starts one process per GPU with its SKY_* variables
  gcloud compute ssh $VM_NAME --zone=$ZONE --command "bash -s" < {script}
done
"""
        else:
            hosts = acc["hosts"]
            marker = f"sky-job-{spec.name}"
            body = f"""#!/bin/bash
# Provision {hosts} GPU VMs ({hosts} x {acc["gpus"]} x H100) and run {spec.num_runs} chained allocations of {spec.name}.
set -e
ZONE=${{ZONE:-us-central1-a}}
VMS=({" ".join(f"{spec.name}-gpu-{h}" for h in range(hosts))})
for VM in "${{VMS[@]}}"; do
  gcloud compute instances create $VM --zone=$ZONE \\
    --machine-type={acc["machine"]} --maintenance-policy=TERMINATE \\
    --image-family=pytorch-latest-gpu --image-project=deeplearning-platform-release \\
    --boot-disk-size=200GB --metadata=install-nvidia-driver=True || true
done
# host 0's internal address: the ranks' coordinator
COORD=$(gcloud compute instances describe ${{VMS[0]}} --zone=$ZONE \\
  --format='get(networkInterfaces[0].networkIP)')
for RUN in $(seq 1 {spec.num_runs}); do
  echo "=== chained run $RUN/{spec.num_runs} ==="
  # the job script on every VM at once, each with its node rank and named
  # {marker} on its command line; the first VM that fails stops the
  # others' scripts (their ranks with them) and the chain
  pids=()
  for NODE in $(seq 0 {hosts - 1}); do
    gcloud compute ssh ${{VMS[$NODE]}} --zone=$ZONE \\
      --command "export {ENV_NODE_RANK}=$NODE {ENV_COORD_HOST}=$COORD; bash -s {marker}" \\
      < {script} &
    pids+=($!)
  done
  status=0
  for _ in "${{pids[@]}}"; do
    if ! wait -n && [ $status = 0 ]; then
      status=1
      for pid in "${{pids[@]}}"; do kill "$pid" 2>/dev/null || true; done
      for VM in "${{VMS[@]}}"; do
        gcloud compute ssh $VM --zone=$ZONE --command "pkill -TERM -f '[{marker[0]}]{marker[1:]}'" || true
      done
    fi
  done
  if [ $status != 0 ]; then
    echo "run $RUN failed on a host: the chain stops"
    exit 1
  fi
done
"""
        with open(driver, "w") as f:
            f.write(body)
        os.chmod(driver, 0o755)
        return driver

    # ------------------------------------------------------------------
    def submit(self, spec: JobSpec, dry_run: bool = False) -> list[str]:
        """Write + submit the job chain; returns submitted job ids/paths."""
        hosts = ACCELERATORS[spec.accelerator]["hosts"]
        if hosts > 1 and self.backend not in MULTI_HOST_BACKENDS:
            raise ValueError(f"{spec.accelerator} spans {hosts} hosts: the {self.backend!r} "
                             f"backend runs on one; queue it with "
                             f"{' or '.join(repr(b) for b in MULTI_HOST_BACKENDS)}")
        script = self.write_script(spec)
        # bookkeeping first: move the script todo -> done and submit that
        # path (avoids racing the job start; ref queue_cc.py:355-378)
        if not dry_run:
            done_path = os.path.join(self.done_dir, os.path.basename(script))
            shutil.move(script, done_path)
            script = done_path
        submitted: list[str] = []

        if self.backend == "slurm":
            dependency = None
            for _ in range(spec.num_runs):
                cmd = self._slurm_command(spec, script, dependency)
                if dry_run:
                    submitted.append(" ".join(cmd))
                    dependency = "<jobid>"
                    continue
                out = subprocess.run(cmd, capture_output=True, text=True, check=True)
                job_id = out.stdout.strip().split()[-1]
                submitted.append(job_id)
                dependency = job_id
        elif self.backend == "gcloud":
            driver = self._gcloud_script(spec, script)
            submitted.append(driver)
            if not dry_run:
                subprocess.Popen(["bash", driver])
        else:  # local: sequential chain in one background session
            log = os.path.join(self.stdout_dir, f"{spec.name}.out")
            chain = " && ".join([f"bash {script}"] * spec.num_runs)
            if dry_run:
                submitted.append(chain)
            else:
                proc = subprocess.Popen(
                    ["bash", "-c", f"({chain}) >> {log} 2>&1"],
                    start_new_session=True,
                )
                self._local.append(proc)
                submitted.append(str(proc.pid))

        return submitted

    def wait(self, timeout: Optional[float] = None) -> list[int]:
        """Wait for the local chains this queue started; their exit codes.
        A chain still running after ``timeout`` seconds is stopped with
        every process of its session (its ranks included) and reported as
        -SIGKILL."""
        deadline = None if timeout is None else time.monotonic() + timeout
        codes = []
        for proc in self._local:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                codes.append(proc.wait(left))
            except subprocess.TimeoutExpired:
                _kill_session(proc.pid)
                codes.append(proc.wait())
        self._local = []
        return codes


def _kill_session(sid: int) -> None:
    """SIGKILL every process of session ``sid`` (read from /proc)."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            if os.getsid(int(entry)) == sid:
                os.kill(int(entry), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            continue


def cancel_slurm_jobs(first_id: int, last_id: int) -> None:
    """scancel an inclusive job-id range (reference ``cancel_simulations.py``)."""
    for job_id in range(first_id, last_id + 1):
        subprocess.run(["scancel", str(job_id)], check=False)
