"""The port's job queue and launchers (``sky_embeddings_tpu_torch/cluster``)
on the CPU: a Slurm dry run chains three runs with ``afterany`` and asks for
``--gres=gpu:N``; the gcloud backend writes a GPU VM driver; the local chain
runs twice and ``JobQueue.wait`` returns its exit code; a two-rank job
script gives each rank its own four ``SKY_*`` values (one coordinator, the
process count, its own id), and fails, stopping the other rank and the
chain, when one rank fails; both launchers write the INI text of JAX's
launchers for the same arguments and queue the port's twins, one process
per GPU.
"""

import sys
import time

import pytest

from sky_embeddings_tpu.cluster import launch_predictor as j_launch_predictor
from sky_embeddings_tpu.cluster import launch_pretraining as j_launch_pretraining
from sky_embeddings_tpu_torch.cluster import launch_predictor, launch_pretraining
from sky_embeddings_tpu_torch.cluster.queue_gpu import ACCELERATORS, JobQueue, JobSpec

ENV_KEYS = ("SKY_DISTRIBUTED", "SKY_COORDINATOR_ADDRESS", "SKY_NUM_PROCESSES", "SKY_PROCESS_ID")


def test_slurm_dry_run_chains_with_afterany_and_gres(tmp_path):
    q = JobQueue(str(tmp_path / "scripts"), backend="slurm")
    spec = JobSpec(name="mim_x", command="python -m x mim_x", num_runs=3, accelerator="h100-4")
    cmds = q.submit(spec, dry_run=True)
    assert len(cmds) == 3
    assert "--dependency" not in cmds[0]
    assert all("--dependency=afterany:<jobid>" in c for c in cmds[1:])
    assert all("--gres=gpu:4" in c and "--nodes=1" in c for c in cmds)
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
    """Rank 1 exits 3 at once while rank 0 would sleep 30 s: the script
    stops rank 0, exits non-zero, and the chain's second run never starts."""
    marker = tmp_path / "started.txt"
    cmd = (f'echo "$SKY_PROCESS_ID" >> {marker}; '
           'if [ "$SKY_PROCESS_ID" = 1 ]; then exit 3; fi; sleep 30')
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
    assert sorted(ACCELERATORS) == ["h100-1", "h100-2", "h100-4", "h100-8"]
    with pytest.raises(SystemExit):
        mod.parse_args(argv + ["-acc", "v5e-8"])
    capsys.readouterr()
