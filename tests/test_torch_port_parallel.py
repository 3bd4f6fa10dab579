"""Port parity, data-parallel training on the CPU: two gloo ranks on
``127.0.0.1`` (one torch thread each, a hard timeout on every process).

* Two ranks, each on its half of the global batch, against one rank on the
  whole batch, in float64 (TinyConv, ``bn_mode="full"``): the loss,
  ``grad_norm``, every parameter after each SGD step and the BN running
  statistics within 1e-9 of each tensor's largest value; with dropout on
  (the global mask, cut per rank) and with ``--iter_size 2`` (two
  mini-steps, one update).
* Two ranks against the JAX package's ``make_train_step`` over a 2-device
  mesh on the whole batch (dropout 0, ``bn_mode`` full): loss and every
  parameter within 1e-4 of each tensor's largest value.
* Each rank's batch equals the slice the JAX CLI's multi-process code
  assembles for that process, exactly.
* Two ranks: save (rank 0) -> every rank restores -> one step, against an
  uninterrupted two-rank run, to 1e-9 in float64.
* Every ``save_checkpoint`` of the training CLIs sits under a rank-0
  guard (as tests/test_multihost.py checks the JAX CLIs).
* ``ssn_train`` as two processes through the multi-host flags: both ranks
  print the same losses, one checkpoint is written, and it loads with no
  ``module.`` keys.
* ``select_devices`` raises the JAX package's ``ValueError``s.

The rank functions import no JAX: the spawned ranks import this module.
"""

import ast
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from action_detection_torch.config import SamplingConfig
from action_detection_torch.models import SSN, seeded_init
from action_detection_torch.parallel import (free_port, initialize_multihost,
                                             select_devices, shard_batch,
                                             wrap_ddp)
from action_detection_torch.train import (LossWeights, batch_to_device,
                                          load_checkpoint, make_optimizer,
                                          make_train_step, save_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = dict(starting_segment=1, course_segment=1, ending_segment=1)
TIMEOUT = 120
#: absolute slack for tensors of rounding noise alone: the conv biases
#: under a batch-statistics BN have a zero gradient up to rounding, and
#: their values stay ~1e-22
FLOOR = 1e-20


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_entry(rank, world, port, job, kwargs):
    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        globals()[job](rank, world, **kwargs)
    finally:
        dist.destroy_process_group()


def run_ranks(job: str, world: int = 2, **kwargs) -> None:
    """``job(rank, world, **kwargs)`` of this module on ``world`` spawned
    gloo ranks; a rank's error or the timeout fails the test."""
    ctx = mp.start_processes(_rank_entry, args=(world, free_port(), job,
                                                kwargs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{job}: ranks still running after {TIMEOUT} s")


def _model(dtype, dropout, state=None):
    model = seeded_init(SSN(num_class=3, base_model="TinyConv",
                            dropout=dropout, bn_mode="full", dtype=dtype,
                            **SEG), seed=1)
    model.to(dtype)
    if state is not None:
        model.load_state_dict(state)
    return model


def train_run(batches, rank=0, world=1, dtype=torch.float64, dropout=0.5,
              iter_size=1, momentum=0.9, state=None):
    """SGD steps of a TinyConv SSN (seeded, ``bn_mode`` full) on this
    rank's slice of each global batch. Returns each step's metrics and the
    final state_dict (and the bare model)."""
    model = _model(dtype, dropout, state)
    opt = make_optimizer(model, base_lr=0.01, lr_steps=[100],
                         steps_per_epoch=len(batches), momentum=momentum,
                         clip_gradient=40.0, iter_size=iter_size)
    step = make_train_step(wrap_ddp(model, "cpu"), opt, SamplingConfig(),
                           LossWeights(), seed=7)
    metrics = []
    for b in batches:
        met = step(batch_to_device(shard_batch(b, rank, world), "cpu"))
        metrics.append({k: v.item() for k, v in met.items()})
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


def steps_job(rank, world, batches, out, **kw):
    torch.save(train_run(batches, rank, world, **kw),
               os.path.join(out, f"rank{rank}.pt"))


def resume_job(rank, world, batches, out):
    """An uninterrupted two-step run, and a run that saves after its first
    step (rank 0), restores in every rank and takes the second."""
    kw = dict(dropout=0.0, momentum=0.0)
    straight = train_run(batches, rank, world, **kw)
    _, state = train_run(batches[:1], rank, world, **kw)
    path = os.path.join(out, "ckpt.pt")
    if rank == 0:
        save_checkpoint(path, state, [[0.0, 0.0], [1.0, 1.0]],
                        arch="TinyConv", epoch=1)
    dist.barrier()
    restored = load_checkpoint(path)["state_dict"]
    resumed = train_run(batches[1:], rank, world, state=restored, **kw)
    torch.save((straight, resumed), os.path.join(out, f"rank{rank}.pt"))


def _close(got: dict, want: dict, rel: float, what: str) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        if not torch.is_tensor(w):
            np.testing.assert_allclose(got[name], w, rtol=rel, atol=0,
                                       err_msg=f"{what} {name}")
            continue
        if not w.is_floating_point():
            assert torch.equal(got[name], w), (what, name)
            continue
        scale = w.abs().max().item()
        err = (got[name].to(w.dtype) - w).abs().max().item()
        assert err <= rel * scale + FLOOR, (what, name, err, scale)


@pytest.fixture(scope="module")
def global_batches(tmp_path_factory):
    """Two global batches of 4 videos (8 proposals x 3 segments of 32^2,
    the training augmentation), numpy."""
    from action_detection_torch.data import pipeline, transforms
    from action_detection_torch.data.ssn_dataset import SSNDataset

    from tests.test_datasets import write_proposal_list

    prop = write_proposal_list(tmp_path_factory.mktemp("pb") / "p.txt",
                               n_videos=4)
    ds = SSNDataset(prop, SamplingConfig(), body_seg=1, aug_seg=1)
    prov = pipeline.SyntheticFrameProvider(48, 40)
    aug = transforms.get_train_augmentation(32, "RGB")
    return [pipeline.assemble_train_batch(ds, vids, prov, aug,
                                          np.random.RandomState(seed))
            for seed, vids in enumerate(([0, 1, 2, 3], [3, 1, 0, 2]))]


@pytest.mark.parametrize("iter_size", [1, 2])
def test_two_ranks_equal_one_rank_float64(global_batches, tmp_path,
                                          iter_size):
    """Dropout 0.5 on: the mask of the global batch is drawn in every rank
    from the shared seed and cut to its rows. ``iter_size`` 2: the two
    batches are two mini-steps of one update, each mini-step's backward
    all-reduced."""
    ref_metrics, ref_state = train_run(global_batches, iter_size=iter_size)
    run_ranks("steps_job", batches=global_batches, out=str(tmp_path),
              iter_size=iter_size)
    before = _model(torch.float64, 0.5).state_dict()
    for rank in range(2):
        metrics, state = torch.load(tmp_path / f"rank{rank}.pt")
        for got, want in zip(metrics, ref_metrics):
            _close(got, want, 1e-9, f"rank {rank} metrics")
        _close(state, ref_state, 1e-9, f"rank {rank} state")
    moved = [k for k in ref_state if not torch.equal(ref_state[k], before[k])]
    assert any(k.endswith("running_var") for k in moved)
    assert any(k.endswith("conv1_7x7_s2.weight") for k in moved)


def test_save_restore_step_equals_uninterrupted(global_batches, tmp_path):
    """Float64, dropout 0, momentum 0 (checkpoints hold no optimizer state,
    in either package): save -> restore in every rank -> step equals the
    uninterrupted run to 1e-9."""
    run_ranks("resume_job", batches=global_batches, out=str(tmp_path))
    for rank in range(2):
        (m_a, s_a), (m_b, s_b) = torch.load(tmp_path / f"rank{rank}.pt")
        _close(m_b[0], m_a[1], 1e-9, f"rank {rank} resumed step")
        _close(s_b, s_a, 1e-9, f"rank {rank} resumed state")


def test_two_ranks_match_jax_mesh_step(tmp_path):
    """Two gloo ranks (one video each) against JAX's jitted step over a
    2-device mesh on both videos, two steps, float32: loss and every
    parameter and running statistic within 1e-4 of its largest value."""
    import jax

    from action_detection_tpu.config import SamplingConfig as JSampling
    from action_detection_tpu.parallel import make_mesh, replicate
    from action_detection_tpu.parallel import shard_batch as j_shard_batch
    from action_detection_tpu.train import LossWeights as JLossWeights
    from action_detection_tpu.train import make_optimizer as j_make_optimizer
    from action_detection_tpu.train import make_train_step as j_make_step

    from action_detection_torch.models import state_dict_from_jax

    from tests.test_datasets import write_proposal_list
    from tests.test_torch_port_train_optim import JSPEC, _jstate, _pair
    from action_detection_torch.data import pipeline, transforms
    from action_detection_torch.data.ssn_dataset import SSNDataset

    prop = write_proposal_list(tmp_path / "p.txt")
    ds = SSNDataset(prop, SamplingConfig(), body_seg=1, aug_seg=1)
    prov = pipeline.SyntheticFrameProvider(48, 40)
    aug = transforms.get_train_augmentation(32, "RGB")
    batches = [pipeline.assemble_train_batch(ds, vids, prov, aug,
                                             np.random.RandomState(seed))
               for seed, vids in enumerate(([0, 1], [1, 2]))]
    jm, v, tm = _pair("full")
    tx = j_make_optimizer(base_lr=0.01, lr_steps=[10], steps_per_epoch=1)
    mesh = make_mesh(jax.devices()[:2])
    state = replicate(_jstate(v, tx), mesh)
    jstep = j_make_step(jm, tx, JSampling(), JSPEC, JLossWeights(),
                        donate=False)
    losses = []
    for b in batches:
        state, met = jstep(state, j_shard_batch(b, mesh),
                           jax.random.PRNGKey(0))
        losses.append(float(met["loss"]))
    want = state_dict_from_jax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))

    run_ranks("jax_twin_job", batches=batches, out=str(tmp_path),
              start=tm.state_dict())
    for rank in range(2):
        metrics, got = torch.load(tmp_path / f"rank{rank}.pt")
        np.testing.assert_allclose([m["loss"] for m in metrics], losses,
                                   rtol=1e-4)
        _close(got, want, 1e-4, f"rank {rank} vs JAX")


def jax_twin_job(rank, world, batches, out, start):
    model = SSN(num_class=3, base_model="TinyConv", dropout=0.0,
                bn_mode="full", **SEG)
    model.load_state_dict(start)
    opt = make_optimizer(model, base_lr=0.01, lr_steps=[10],
                         steps_per_epoch=1)
    step = make_train_step(wrap_ddp(model, "cpu"), opt, SamplingConfig(),
                           LossWeights())
    metrics = [{k: v.item() for k, v in step(batch_to_device(
        shard_batch(b, rank, world), "cpu")).items()} for b in batches]
    torch.save((metrics, model.state_dict()),
               os.path.join(out, f"rank{rank}.pt"))


def test_rank_batches_equal_jax_multiprocess_slices(tmp_path):
    """``ssn_train``'s ``batch_maker`` for each of 2 ranks against the JAX
    CLI's multi-process assembly (``cli/ssn_train.py:140-148``: the
    rank's ``local_bs`` slice of the global indices, the step's
    ``RandomState(step_seeds[i])``), bit for bit."""
    from action_detection_tpu.config import SamplingConfig as JSampling
    from action_detection_tpu.data.pipeline import SyntheticFrameProvider
    from action_detection_tpu.data.pipeline import \
        assemble_train_batch as j_assemble
    from action_detection_tpu.data.ssn_dataset import SSNDataset as JDataset
    from action_detection_tpu.data.transforms import \
        get_train_augmentation as j_augmentation

    from action_detection_torch.cli.ssn_train import batch_maker
    from action_detection_torch.data import pipeline, transforms
    from action_detection_torch.data.ssn_dataset import SSNDataset

    from tests.test_datasets import write_proposal_list

    prop = write_proposal_list(tmp_path / "p.txt", n_videos=4)
    ds = SSNDataset(prop, SamplingConfig(), body_seg=1, aug_seg=1)
    jds = JDataset(prop, JSampling(), body_seg=1, aug_seg=1)
    batch_size, world, steps = 4, 2, 2
    order = np.arange(len(ds))
    epoch_rng = np.random.RandomState(0 * 1000 + 0)
    epoch_rng.shuffle(order)
    batch_order = np.tile(order, 2)[:steps * batch_size]
    step_seeds = epoch_rng.randint(2 ** 31, size=steps)
    local_bs = batch_size // world
    for proc_id in range(world):
        make = batch_maker(ds, pipeline.SyntheticFrameProvider(48, 40),
                           transforms.get_train_augmentation(32, "RGB"),
                           batch_order, step_seeds, batch_size,
                           slice(proc_id * local_bs,
                                 (proc_id + 1) * local_bs))
        for i in range(steps):
            idxs = batch_order[i * batch_size:(i + 1) * batch_size]
            idxs = idxs[proc_id * local_bs:(proc_id + 1) * local_bs]
            want = j_assemble(jds, idxs, SyntheticFrameProvider(48, 40),
                              j_augmentation(32, "RGB"),
                              np.random.RandomState(step_seeds[i]))
            got = make(i)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def _guarded_by_rank0(node, parents) -> bool:
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            t = node.test
            if (isinstance(t.left, ast.Name) and t.left.id == "rank"
                    and isinstance(t.ops[0], ast.Eq)
                    and isinstance(t.comparators[0], ast.Constant)
                    and t.comparators[0].value == 0):
                return True
    return False


@pytest.mark.parametrize("cli", ["ssn_train", "binary_train"])
def test_only_rank0_writes_checkpoints(cli):
    """Every ``save_checkpoint`` call of the port's training CLIs sits
    under ``if rank == 0``: ranks on a shared filesystem must not race on
    one path (``os.replace`` of N temp files)."""
    path = os.path.join(ROOT, "action_detection_torch", "cli", f"{cli}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "save_checkpoint"]
    assert calls
    for call in calls:
        assert _guarded_by_rank0(call, parents), (cli, call.lineno)


def test_ssn_train_two_processes_through_multihost_flags(tmp_path):
    """``ssn_train`` (TinyConv, 2 steps of -b 2, dropout on) as two
    processes joined by ``--coordinator_address/--num_processes/
    --process_id`` on gloo: both print the same losses, exactly one
    checkpoint (and its model_best copy) is written, and it loads with
    the bare model's keys."""
    from action_detection_torch.models import SSN as PortSSN

    from tests.test_datasets import write_proposal_list

    write_proposal_list(tmp_path / "thumos14_tag_val_proposal_list.txt",
                        n_videos=2)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "action_detection_torch.cli.ssn_train",
         "thumos14", "RGB", "--arch", "TinyConv", "--synthetic_data",
         "--device", "cpu", "-b", "2", "--tem", "2", "--epochs", "1", "-j",
         "1", "--print-freq", "1", "--prop_file_dir", str(tmp_path),
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
         "2", "--process_id", str(i)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    losses = [re.search(r"rank (\d) of 2\).*losses (\[.*\])", out)
              for out in outs]
    assert [m.group(1) for m in losses] == ["0", "1"], outs
    assert losses[0].group(2) == losses[1].group(2)
    assert len(eval(losses[0].group(2))) == 2
    assert "Epoch: [0][1/2]" in outs[0] and "Epoch:" not in outs[1]
    written = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    assert written == ["ssn_thumos14_TinyConv_rgb_checkpoint.pt",
                       "ssn_thumos14_TinyConv_rgb_model_best.pt"]
    ck = load_checkpoint(str(tmp_path / written[0]))
    assert not any(k.startswith("module.") for k in ck["state_dict"])
    assert set(ck["state_dict"]) == set(
        PortSSN(num_class=20, base_model="TinyConv").state_dict())


def test_save_checkpoint_refuses_ddp_keys(tmp_path):
    with pytest.raises(ValueError, match="module."):
        save_checkpoint(str(tmp_path / "c.pt"),
                        {"module.activity_fc.weight": torch.zeros(2)}, None)


def test_select_devices_raises_as_jax_does():
    """Duplicate and out-of-range ``--gpus`` raise ``ValueError`` with the
    JAX package's messages; None is every local device."""
    from action_detection_tpu.parallel import select_devices as j_select

    for port, jax_ in (([0, 0], [0, 0]), ([0, 1], [0, 9])):
        with pytest.raises(ValueError) as got:
            select_devices(port, "cpu")
        with pytest.raises(ValueError) as want:
            j_select(jax_)
        pattern = re.sub(r"\d+", r"\\d+", re.escape(str(want.value)))
        assert re.fullmatch(pattern, str(got.value)), (got.value, want.value)
    assert select_devices(None, "cpu") == [torch.device("cpu")]
    assert select_devices([0], "cpu") == [torch.device("cpu")]


def test_ssn_train_spawns_one_rank_per_local_device(tmp_path, monkeypatch):
    """Several local devices: ``launch`` spawns one rank per device
    (``torch.multiprocessing``), joins them on a free local port and
    returns rank 0's ``RunStats``. Two CPU "devices" stand for two GPUs
    (the CPU is one device to ``cli_devices``)."""
    from action_detection_torch import parallel
    from action_detection_torch.cli import ssn_train

    from tests.test_datasets import write_proposal_list

    write_proposal_list(tmp_path / "thumos14_tag_val_proposal_list.txt",
                        n_videos=2)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(parallel, "cli_devices",
                        lambda device, indices: [torch.device("cpu")] * 2)
    stats = ssn_train.main(["thumos14", "RGB", "--arch", "TinyConv",
                            "--synthetic_data", "--device", "cpu", "-b", "2",
                            "--tem", "2", "--epochs", "1", "-j", "1",
                            "--print-freq", "1", "--prop_file_dir",
                            str(tmp_path)])
    assert len(stats.step_ms) == 2 and len(stats.losses) == 2
    assert stats.images == 1 * 8 * 9          # one video a rank
    ck = load_checkpoint("ssn_thumos14_TinyConv_rgb_checkpoint.pt")
    assert ck["epoch"] == 1 and ck["best_loss"] == stats.best_loss
