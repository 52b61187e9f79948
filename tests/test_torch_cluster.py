"""The port's job queue and launchers (``sky_embeddings_tpu_torch/cluster``)
on the CPU: a Slurm dry run chains three runs with ``afterany`` and asks for
``--gres=gpu:N``, one node for every one-host entry; the gcloud backend
writes a GPU VM driver; the local chain runs twice and ``JobQueue.wait``
returns its exit code; a two-rank job script gives each rank its own four
``SKY_*`` values (one coordinator, the process count, its own id), and
fails, stopping the other rank and the chain, when one rank fails; both
launchers write the INI text of JAX's launchers for the same arguments and
queue the port's twins, one process per GPU. Across hosts (``h100-16``,
``h100-32``): Slurm gets one task a node under ``srun``, the script reads
its node rank and host 0 from Slurm's variables (a stand-in ``scontrol``)
or the gcloud driver's, the driver (run with a stand-in ``gcloud`` that
runs each VM's script here) starts every VM's script with its node rank and
stops the chain when one fails, ``local`` refuses them, and one job script
run twice at once as two one-GPU "hosts" joins a gloo group and
all-reduces the ranks' ids.
"""

import os
import socket
import stat
import subprocess
import sys
import time

import pytest

from sky_embeddings_tpu.cluster import launch_predictor as j_launch_predictor
from sky_embeddings_tpu.cluster import launch_pretraining as j_launch_pretraining
from sky_embeddings_tpu_torch.cluster import launch_predictor, launch_pretraining
from sky_embeddings_tpu_torch.cluster import queue_gpu
from sky_embeddings_tpu_torch.cluster.queue_gpu import ACCELERATORS, JobQueue, JobSpec, job_port

ENV_KEYS = ("SKY_DISTRIBUTED", "SKY_COORDINATOR_ADDRESS", "SKY_NUM_PROCESSES", "SKY_PROCESS_ID")


def test_slurm_dry_run_chains_with_afterany_and_gres(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="slurm")
    spec = JobSpec(name="mim_x", command="python -m x mim_x", num_runs=3, accelerator="h100-4")
    cmds = q.submit(spec, dry_run=True)
    assert len(cmds) == 3
    assert "--dependency" not in cmds[0]
    assert all("--dependency=afterany:<jobid>" in c for c in cmds[1:])
    assert all("--gres=gpu:4" in c for c in cmds)
    script = tmp_path / "scripts/todo/mim_x.sh"
    assert script.exists() and "seq 0 3" in script.read_text()
    with pytest.raises(ValueError, match="backend"):
        JobQueue(str(tmp_path / "s2"), backend="tpu")


def test_gcloud_driver_provisions_a_gpu_vm(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="gcloud")
    driver = q.submit(JobSpec(name="run", command="true", num_runs=4, accelerator="h100-8"),
                      dry_run=True)[0]
    text = open(driver).read()
    assert "VM_NAME=run-gpu" in text and "gcloud compute instances create $VM_NAME" in text
    assert "--machine-type=a3-highgpu-8g" in text and "$(seq 1 4)" in text
    assert "tpu" not in text and text.count("gcloud compute ssh") == 1


def test_local_chain_runs_twice(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="local")
    marker = tmp_path / "ran.txt"
    assert q.submit(JobSpec(name="t", command=f"echo run >> {marker}", num_runs=2,
                            accelerator="h100-1"), dry_run=True)[0].count("bash") == 2
    q.submit(JobSpec(name="t", command=f"echo run >> {marker}", num_runs=2,
                     accelerator="h100-1"))
    assert q.wait(timeout=60) == [0]
    assert marker.read_text() == "run\nrun\n"
    assert (tmp_path / "scripts/done/t.sh").exists()
    assert not (tmp_path / "scripts/todo/t.sh").exists()


def _env_dump(out_dir):
    """A command that writes the rank's four SKY_* values to <out>/rank<id>."""
    keys = ", ".join(repr(k) for k in ENV_KEYS)
    code = (f"import os; open(os.path.join({str(out_dir)!r}, 'rank' + os.environ['SKY_PROCESS_ID']),"
            f" 'a').write(' '.join(os.environ[k] for k in ({keys})) + chr(10))")
    return f'{sys.executable} -c "{code}"'


def _until(path, lines):
    """A shell loop that waits, 20 s at most, until ``path`` holds ``lines``
    lines: a failing rank waits so for its peers to have started, as a
    rank that fails later in a real run would."""
    return (f'for _ in $(seq 200); do [ "$(wc -l < {path} 2>/dev/null || echo 0)" -ge {lines} ] '
            '&& break; sleep 0.1; done')


def test_two_rank_job_script_sets_each_ranks_contract(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="local")
    q.submit(JobSpec(name="dp", command=_env_dump(tmp_path), num_runs=2, accelerator="h100-2"))
    assert q.wait(timeout=60) == [0]
    runs = {r: (tmp_path / f"rank{r}").read_text().splitlines() for r in (0, 1)}
    assert len(runs[0]) == len(runs[1]) == 2  # one line a rank a chained run
    for run in range(2):
        vals = [runs[r][run].split() for r in (0, 1)]
        for r, (flag, coord, nproc, pid) in enumerate(vals):
            assert (flag, nproc, pid) == ("1", "2", str(r))
            host, port = coord.split(":")
            assert host == "127.0.0.1" and 0 < int(port) < 65536
        assert vals[0][1] == vals[1][1]  # one coordinator for the ranks of a run


def test_failed_rank_fails_the_job_and_stops_its_peer(tmp_path):
    """Rank 1 exits 3 once rank 0 has started, while rank 0 would sleep 30
    s: the script stops rank 0, exits non-zero, and the chain's second run
    never starts."""
    marker = tmp_path / "started.txt"
    cmd = (f'echo "$SKY_PROCESS_ID" >> {marker}; '
           f'if [ "$SKY_PROCESS_ID" = 1 ]; then {_until(marker, 2)}; exit 3; fi; sleep 30')
    q = JobQueue(str(tmp_path / "scripts"), backend="local")
    t0 = time.monotonic()
    q.submit(JobSpec(name="bad", command=cmd, num_runs=2, accelerator="h100-2"))
    codes = q.wait(timeout=60)
    assert codes[0] != 0 and time.monotonic() - t0 < 20
    assert sorted(marker.read_text().split()) == ["0", "1"]  # one run, both ranks


def test_wait_stops_a_chain_past_its_timeout(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="local")
    q.submit(JobSpec(name="slow", command="sleep 60", num_runs=1, accelerator="h100-2"))
    t0 = time.monotonic()
    assert q.wait(timeout=1.0) == [-9]
    assert time.monotonic() - t0 < 10


PRETRAIN_ARGV = [
    ["mim_gen", "-vdf", "val.h5", "-tdf", "train.h5", "-bs", "32", "-ti", "5000", "-ed", "96",
     "-nc", "3", "-is", "16", "-ps", "4", "-mt", "simmim", "-lpc", "p.h5", "-cmt", "a run"],
    ["mae_gen", "-vdf", "val.h5", "-tdf", "t.h5", "-mt", "base", "-mr", "0.6", "-rd", "True"],
    ["fits_gen", "-vdf", "val.h5", "-tdp", "['/survey/tiles']", "-bands", "['G','R']", "-mb", "2"],
]
PREDICTOR_ARGV = [
    ["z_gen", "-mae", "mim_gen", "-tdf", "train.h5", "-vdf", "val.h5", "-lk", "['zspec']",
     "-lm", "[0.64]", "-ls", "[0.64]", "-bs", "64", "-ti", "300"],
    ["c_gen", "-mae", "mim_1", "-tdf", "t.h5", "-vdf", "v.h5", "-lk", "['class']", "-ncl", "3",
     "-tm", "lp", "-loss", "crossentropy", "-gp", "avg", "-do", "0.1"],
]


def _jax_args(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    return module.parse_args()


@pytest.mark.parametrize("argv", PRETRAIN_ARGV + PREDICTOR_ARGV, ids=lambda a: a[0])
def test_launchers_write_jax_ini_text(argv, tmp_path, monkeypatch):
    ours, theirs = ((launch_pretraining, j_launch_pretraining) if argv in PRETRAIN_ARGV
                    else (launch_predictor, j_launch_predictor))
    ours.build_config(ours.parse_args(argv)).to_ini(str(tmp_path / "port.ini"))
    theirs.build_config(_jax_args(theirs, argv, monkeypatch)).to_ini(str(tmp_path / "jax.ini"))
    assert (tmp_path / "port.ini").read_text() == (tmp_path / "jax.ini").read_text()


@pytest.mark.parametrize("which", ["pretraining", "predictor"])
def test_launchers_queue_the_port_twins(which, tmp_path, monkeypatch, capsys):
    mod = launch_pretraining if which == "pretraining" else launch_predictor
    (tmp_path / "configs").mkdir()
    monkeypatch.setattr(mod, "REPO_DIR", str(tmp_path))
    argv = (PRETRAIN_ARGV[0] if which == "pretraining" else PREDICTOR_ARGV[0] + ["--run_eval"])
    submitted = mod.main(argv + ["-dd", "/data", "--dry_run", "--backend", "slurm", "-nr", "2"])
    name = argv[0]
    assert (tmp_path / "configs" / f"{name}.ini").exists()
    assert len(submitted) == 2 and "--gres=gpu:8" in submitted[0]
    script = (tmp_path / "scripts" / "todo" / f"{name}.sh").read_text()
    twin = "pretrain_mim" if which == "pretraining" else "train_predictor"
    assert f"cd {tmp_path} && python -m sky_embeddings_tpu_torch.{twin} {name} " in script
    assert "-dd /data" in script and "seq 0 7" in script
    for key in ENV_KEYS:
        assert key in script
    if which == "predictor":
        assert ('if [ "$SKY_PROCESS_ID" = 0 ]; then python -m '
                f"sky_embeddings_tpu_torch.test_predictor {name} -dd /data; fi") in script
    assert sorted(ACCELERATORS) == ["h100-1", "h100-16", "h100-2", "h100-32", "h100-4", "h100-8"]
    with pytest.raises(SystemExit):
        mod.parse_args(argv + ["-acc", "v5e-8"])
    capsys.readouterr()


# ---- jobs across hosts ----------------------------------------------------------

ONE_HOST = ("h100-1", "h100-2", "h100-4", "h100-8")


@pytest.mark.parametrize("acc", ONE_HOST)
def test_one_host_entries_ask_slurm_for_one_node(acc, tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="slurm")
    cmds = q.submit(JobSpec(name="one", command="true", num_runs=2, accelerator=acc), dry_run=True)
    gpus = ACCELERATORS[acc]["gpus"]
    assert ACCELERATORS[acc]["hosts"] == 1
    for c in cmds:
        assert "--nodes=1" in c and f"--gres=gpu:{gpus}" in c
        assert "--ntasks-per-node" not in c and "srun" not in c
        assert c.endswith(str(tmp_path / "scripts/todo/one.sh"))
    text = (tmp_path / "scripts/todo/one.sh").read_text()
    assert "SKY_COORDINATOR_ADDRESS=127.0.0.1:$SKY_PORT" in text and "NODE_RANK" not in text


@pytest.mark.parametrize("acc,hosts", [("h100-16", 2), ("h100-32", 4)])
def test_slurm_dry_run_across_hosts_runs_the_script_once_a_node(acc, hosts, tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="slurm")
    cmds = q.submit(JobSpec(name="big", command="true", num_runs=3, accelerator=acc),
                    dry_run=True)
    script = tmp_path / "scripts/todo/big.sh"
    assert len(cmds) == 3 and "--dependency" not in cmds[0]
    assert all("--dependency=afterany:<jobid>" in c for c in cmds[1:])
    for c in cmds:
        assert f"--nodes={hosts}" in c and "--ntasks-per-node=1" in c and "--gres=gpu:8" in c
        assert c.endswith(f"--wrap=srun --kill-on-bad-exit=1 bash {script}")
    text = script.read_text()
    assert "seq 0 7" in text and f"SKY_NUM_PROCESSES={8 * hosts}" in text
    assert f"SKY_PORT=${{SKY_COORDINATOR_PORT:-{job_port('big')}}}" in text


def _stand_in(bin_dir, name, body):
    """An executable ``name`` on a directory put first on PATH."""
    bin_dir.mkdir(exist_ok=True)
    path = bin_dir / name
    path.write_text("#!/bin/bash\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


ENV_LINE = 'echo "$SKY_DISTRIBUTED $SKY_NUM_PROCESSES $SKY_COORDINATOR_ADDRESS" > {out}/rank$SKY_PROCESS_ID'


@pytest.mark.parametrize("route", ["slurm", "gcloud"])
def test_node_1_local_rank_3_of_h100_16_is_rank_11_of_16(route, tmp_path):
    """The h100-16 script as the second host runs it: its eight ranks are
    8..15, local rank 3 reads SKY_PROCESS_ID=11 of 16, and every rank's
    coordinator is host 0 on the job's port. Slurm's route reads
    SLURM_NODEID and the first name ``scontrol`` gives for the node list;
    the gcloud driver's SKY_NODE_RANK and SKY_COORDINATOR_HOST."""
    out = tmp_path / "out"
    out.mkdir()
    q = JobQueue(str(tmp_path / "scripts"), backend=route)
    q.write_script(JobSpec(name="big", command=ENV_LINE.format(out=out), accelerator="h100-16"))
    env = dict(os.environ)
    if route == "slurm":
        bin_dir = tmp_path / "bin"
        _stand_in(bin_dir, "scontrol", 'echo gpu-a\necho gpu-b\n')
        env.update(SLURM_NODEID="1", SLURM_JOB_NODELIST="gpu-[a-b]",
                   PATH=f"{bin_dir}:{env['PATH']}")
        host0 = "gpu-a"
    else:
        env.update(SKY_NODE_RANK="1", SKY_COORDINATOR_HOST="10.0.0.2")
        host0 = "10.0.0.2"
    proc = subprocess.run(["bash", str(tmp_path / "scripts/todo/big.sh")], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert sorted(int(p.name[4:]) for p in out.iterdir()) == list(range(8, 16))
    assert (out / "rank11").read_text().split() == ["1", "16", f"{host0}:{job_port('big')}"]


def test_gcloud_driver_starts_every_vm_with_its_node_rank(tmp_path):
    """The h100-16 driver run with a stand-in ``gcloud`` that records each
    call and runs an ssh command's script here: two VMs created, host 0's
    address asked, and in each of two chained runs the script started on
    both VMs with node ranks 0 and 1, the ranks 0..15 between them. Then a
    job whose host 1 fails while a rank of host 0 still runs: the driver
    stops the job script on every VM (``pkill`` of its marker, which stops
    the host's ranks), the first run fails and the chain stops."""
    calls, out = tmp_path / "calls.txt", tmp_path / "out"
    out.mkdir()
    bin_dir = tmp_path / "bin"
    _stand_in(bin_dir, "gcloud", f"""echo "$*" >> {calls}
case "$*" in
  *"instances describe"*) echo 127.0.0.1 ;;
  *"compute ssh"*) for a in "$@"; do case "$a" in --command=*) c="${{a#--command=}}" ;; esac; done
                   prev=""; for a in "$@"; do [ "$prev" = --command ] && c="$a"; prev="$a"; done
                   bash -c "$c" ;;
esac
""")
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    q = JobQueue(str(tmp_path / "scripts"), backend="gcloud")
    cmd = ENV_LINE.format(out=out).replace(" > ", " >> ")
    driver = q.submit(JobSpec(name="pod", command=cmd, num_runs=2, accelerator="h100-16"),
                      dry_run=True)[0]
    text = open(driver).read()
    assert "VMS=(pod-gpu-0 pod-gpu-1)" in text and "--machine-type=a3-highgpu-8g" in text
    proc = subprocess.run(["bash", driver], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    log = calls.read_text().splitlines()
    assert sorted(line.split()[3] for line in log if "instances create" in line) == \
        ["pod-gpu-0", "pod-gpu-1"]
    ssh = [line for line in log if "compute ssh" in line]
    assert len(ssh) == 4  # two VMs, two chained runs
    for vm, node in (("pod-gpu-0", 0), ("pod-gpu-1", 1)):
        mine = [line for line in ssh if line.split()[2] == vm]
        assert len(mine) == 2
        assert all(f"SKY_NODE_RANK={node} SKY_COORDINATOR_HOST=127.0.0.1;" in line for line in mine)
    assert sorted(int(p.name[4:]) for p in out.iterdir()) == list(range(16))
    for p in out.iterdir():
        assert p.read_text().splitlines() == [f"1 16 127.0.0.1:{job_port('pod')}"] * 2

    # every rank writes, then rank 12 (host 1) fails once its peers have,
    # while rank 3 (host 0) would run on for 90 s
    ran = tmp_path / "ran"
    fail = (f'echo ran >> {ran}; if [ "$SKY_PROCESS_ID" = 12 ]; then {_until(ran, 16)}; exit 5; '
            'fi; if [ "$SKY_PROCESS_ID" = 3 ]; then sleep 90; fi')

    driver = q.submit(JobSpec(name="podfail", command=fail, num_runs=3, accelerator="h100-16"),
                      dry_run=True)[0]
    calls.write_text("")
    t0 = time.monotonic()
    proc = subprocess.run(["bash", driver], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "run 1 failed on a host" in proc.stdout
    assert "chained run 2/3" not in proc.stdout
    assert len(ran.read_text().split()) == 16  # the first run's ranks alone
    stops = [line.split()[2] for line in calls.read_text().splitlines()
             if "pkill -TERM -f '[s]ky-job-podfail'" in line]
    assert stops == ["podfail-gpu-0", "podfail-gpu-1"]
    assert time.monotonic() - t0 < 60  # rank 3 stopped, not waited for


@pytest.mark.parametrize("acc", ["h100-16", "h100-32"])
def test_local_refuses_a_job_across_hosts(acc, tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="local")
    with pytest.raises(ValueError, match="'slurm' or 'gcloud'"):
        q.submit(JobSpec(name="big", command="true", accelerator=acc))
    assert not (tmp_path / "scripts/todo/big.sh").exists()


ALL_REDUCE = """import os, sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
from sky_embeddings_tpu_torch.parallel.distributed import initialize_from_env
assert initialize_from_env(log_fn=lambda *a: None, backend="gloo", device="cpu")
t = torch.tensor([float(dist.get_rank())])
dist.all_reduce(t)
open(os.path.join({out!r}, "rank" + os.environ["SKY_PROCESS_ID"]), "w").write(
    f"{{dist.get_rank()}} {{dist.get_world_size()}} {{t.item()}} " + os.environ["SKY_COORDINATOR_ADDRESS"])
dist.destroy_process_group()
"""


def test_two_host_job_script_joins_one_gloo_group(tmp_path, monkeypatch):
    """One job script of two one-GPU hosts, run twice at once as node ranks
    0 and 1 with host 0 at 127.0.0.1 on a fixed port: the two processes are
    ranks 0 and 1 of one gloo group, and the all-reduce of their ids gives
    1 on both."""
    monkeypatch.setitem(queue_gpu.ACCELERATORS, "cpu-2x1",
                        dict(hosts=2, gpus=1, machine="none"))
    out = tmp_path / "out"
    out.mkdir()
    code = tmp_path / "allreduce.py"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code.write_text(ALL_REDUCE.format(root=root, out=str(out)))
    q = JobQueue(str(tmp_path / "scripts"), backend="slurm")
    script = q.write_script(JobSpec(name="two", command=f"{sys.executable} {code}",
                                    accelerator="cpu-2x1"))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("SLURM_")}
    env.update(SKY_COORDINATOR_HOST="127.0.0.1", SKY_COORDINATOR_PORT=str(port),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(["bash", script], env=dict(env, SKY_NODE_RANK=str(node)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for node in (0, 1)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for rank in (0, 1):
        got = (out / f"rank{rank}").read_text().split()
        assert got == [str(rank), "2", "1.0", f"127.0.0.1:{port}"]
