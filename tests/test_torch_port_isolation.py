"""The port runs on a machine without jax, flax, optax, yaml, PIL,
scikit-learn, pandas or msgpack.

A subprocess blocks those packages (``sys.modules[name] = None`` makes
any import of them raise), imports every module of action_detection_torch,
scores a synthetic video through the int8-e2e shared-stem ProposalScorer on
the CPU (plain kernels) for BNInception RGB (frames already at the scale
size), InceptionV3 RGB (frames resized by the numpy resize) and BNInception
and InceptionV3 Flow (10-channel stacks), resizes a THUMOS frame to
InceptionV3's scale size 341, and takes one BNInception SSN training step
(the max-pool backward on its plain version). A second one, under the same
blocks, runs the inference pipeline through the five host and actionness
CLIs on the CPU: gen_sliding_window_proposals -> binary_test (TinyConv) ->
gen_bottom_up_proposals -> ssn_test -> eval_detection_results (no pandas:
its side dumps are skipped), and gen_proposal_list; ssn_test also scores
one TinyConv SSN from a JAX checkpoint.msgpack and from a reference-style
.pth.tar (written by the test process, which has flax) to the pickle of its
.pt. A third trains on the
CPU through the training CLIs: ssn_train (one TinyConv step, validation, a
checkpoint), ssn_train --evaluate on it, and binary_train (one step). Three
more, one a path of the scoring CLI surface: the per-layer int8
BNInception scorer (static and dynamic scales; ``ssn_test --int8_mode
perlayer``), RGBDiff (the int8-e2e shared-stem scorer, ``ssn_train`` and
``binary_train``), and host crops (``ssn_test --test_crops 1``,
``binary_test --host_crops`` and ``--test_crops 1``). And one trains data
parallel: ``ssn_train`` as two processes joined on gloo by the multi-host
flags, each under the blocks."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "PIL", "sklearn",
           "pandas", "msgpack")
BLOCK = textwrap.dedent(f"""
    import sys
    BLOCKED = {BLOCKED!r}
    for blocked in BLOCKED:
        sys.modules[blocked] = None
""")

SCRIPT = BLOCK + textwrap.dedent("""

    import importlib, os, pickle, pkgutil, tempfile
    import numpy as np
    import action_detection_torch

    names = [m.name for m in pkgutil.walk_packages(
        action_detection_torch.__path__, "action_detection_torch.")]
    for name in names:
        importlib.import_module(name)

    from action_detection_torch.config import get_configs
    from action_detection_torch.data.pipeline import (
        SyntheticFrameProvider, collect_calibration_frames,
        make_test_transform)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.infer.scorer import (
        ProposalScorer, dump_scores_pickle, score_videos)
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.data.transforms import scale_frame
    from action_detection_torch.models.backbones import InputSpec

    big = scale_frame(np.zeros((256, 340, 3), np.uint8), 341)
    assert big.shape == (341, 452, 3), big.shape

    def score(pf, arch, modality, size, frame_wh):
        new_length = 1 if modality == "RGB" else 5
        ds = SSNDataset(pf, cfg.sampling, new_length=new_length,
                        test_interval=60)
        model = seeded_init(SSN(num_class=20, base_model=arch,
                                modality=modality, dropout=0.0), seed=0)
        base = model.input_spec
        spec = InputSpec(size, base.mean, base.std, base.bgr, base.div255)
        provider = SyntheticFrameProvider(width=frame_wh[0],
                                          height=frame_wh[1],
                                          modality=modality)
        calib = collect_calibration_frames(
            ds, provider, make_test_transform(spec.input_size,
                                              spec.scale_size, 10),
            new_length=new_length)
        factory = lambda dev: ProposalScorer(
            model, spec, reg_stats=np.array([[0.0, 0.0], [1.0, 1.0]]),
            num_class=20, chunk_frames=4, modality=modality, device=dev,
            quantize="e2e", calibration_frames=calib, shared_stem=True)
        res = score_videos(factory, ds, provider, devices=["cpu"])
        out = os.path.join(d, "scores.pkl")
        dump_scores_pickle(res, out)
        with open(out, "rb") as f:
            return pickle.load(f)

    all_scores = []
    with tempfile.TemporaryDirectory() as d:
        pf = os.path.join(d, "props.txt")
        with open(pf, "w") as f:
            f.write("# 0\\nvideo_0\\n300\\n1\\n1\\n2 60 200\\n3\\n"
                    "2 0.8500 0.9000 50 210\\n2 0.2000 0.9000 90 150\\n"
                    "0 0.0000 0.0000 230 290\\n")
        cfg = get_configs("thumos14")
        # 97x73 frames are already at the 64^2 spec's scale size (73); the
        # 75^2 spec's (85) resizes them
        for arch, modality, size in (("BNInception", "RGB", 64),
                                     ("InceptionV3", "RGB", 75),
                                     ("BNInception", "Flow", 64),
                                     ("InceptionV3", "Flow", 75)):
            all_scores.append(score(pf, arch, modality, size, (97, 73)))
        provider = SyntheticFrameProvider(width=97, height=73)
        from action_detection_torch.data.pipeline import assemble_train_batch
        from action_detection_torch.data.transforms import (
            Compose, GroupCenterCrop, GroupRandomHorizontalFlip, GroupScale)
        from action_detection_torch.train import (
            batch_to_device, make_optimizer, make_train_step)
        tds = SSNDataset(pf, cfg.sampling, body_seg=1, aug_seg=1,
                         reg_stats=np.array([[0.0, 0.0], [1.0, 1.0]]))
        aug = Compose([GroupScale(73), GroupCenterCrop(64),
                       GroupRandomHorizontalFlip()])
        batch = assemble_train_batch(tds, [0], provider, aug,
                                     np.random.RandomState(0))
        tmodel = seeded_init(SSN(num_class=20, starting_segment=1,
                                 course_segment=1, ending_segment=1), seed=1)
        step = make_train_step(tmodel, make_optimizer(tmodel, 0.001, [3], 1),
                               cfg.sampling)
        met = step(batch_to_device(batch, "cpu"))
    assert all(np.isfinite(v.item()) for v in met.values()), met
    for scores in all_scores:
        rel, act, comp, reg = scores["video_0"]
        assert act.shape == (3, 21) and comp.shape == (3, 20)
        assert reg.shape == (3, 20, 2)
        assert all(np.isfinite(a).all() for a in (act, comp, reg))
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("ISOLATED-OK", len(names))
""")

PIPELINE = BLOCK + textwrap.dedent("""
    import os, pickle, tempfile
    import numpy as np

    from action_detection_torch.cli import (
        binary_test, eval_detection_results, gen_bottom_up_proposals,
        gen_proposal_list, gen_sliding_window_proposals, ssn_test)
    from action_detection_torch.data.proposal_io import load_proposal_file
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.models import (SSN, BinaryClassifier,
                                               seeded_init)
    from action_detection_torch.train import save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        db, frames = os.path.join(d, "thumos_14"), os.path.join(d, "frames")
        for subset, vids in (("validation", ["video_validation_0001"]),
                             ("test", ["video_test_0001",
                                       "video_test_0002"])):
            os.makedirs(os.path.join(db, f"temporal_annotations_{subset}"))
            with open(os.path.join(db, f"{subset}_durations.txt"), "w") as f:
                f.writelines(f"{v}.mp4\\n60.0\\n" for v in vids)
            with open(os.path.join(db, f"{subset}_avoid_videos.txt"),
                      "w") as f:
                f.write("")
            for c, cls in enumerate(("Archery", "Diving")):
                with open(os.path.join(db, f"temporal_annotations_{subset}",
                                       f"{cls}_{subset}.txt"), "w") as f:
                    f.writelines(f"{v} {10 + 25 * c:.1f} {22 + 25 * c:.1f}\\n"
                                 for v in vids)
            for v in vids:
                os.makedirs(os.path.join(frames, v))
                for i in range(1, 181):        # 3 fps
                    open(os.path.join(frames, v, f"img_{i:05d}.jpg"),
                         "w").close()

        gen_sliding_window_proposals.main([
            "testing", "rgb", frames, "thumos14_sw_test_proposal_list.txt",
            "--dataset", "thumos14", "--data_dir", d])
        bmodel = seeded_init(BinaryClassifier(base_model="TinyConv"), seed=0)
        save_checkpoint("b.pt", bmodel.state_dict(), None, arch="TinyConv")
        reset_launch_counts()
        act = binary_test.main([
            "thumos14", "RGB", "testing", "b.pt", "act.pkl", "--arch",
            "TinyConv", "--synthetic_data", "--prop_file_dir", d,
            "--device", "cpu", "--test_batchsize", "8"])
        assert sorted(act) == ["video_test_0001", "video_test_0002"]
        assert all(a.shape == (36, 10, 2) and np.isfinite(a).all()
                   for a in act.values())
        gen_bottom_up_proposals.main([
            "act.pkl", "--dataset", "thumos14", "--subset", "testing",
            "--data_dir", d, "--frame_path", frames, "--workers", "1",
            "--thresholds", "0.3", "0.5", "0.7", "--write_proposals",
            "thumos14_tag_test_proposal_list.txt"])
        counts = launch_counts()
        assert counts["host_tag_search"] > 0 and counts["host_nms"] == 2
        groups = load_proposal_file("thumos14_tag_test_proposal_list.txt")
        assert len(groups) == 2 and all(len(g[3]) > 0 for g in groups)

        smodel = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=1)
        save_checkpoint("s.pt", smodel.state_dict(),
                        np.array([[0.0, 0.0], [0.1, 0.1]]), arch="TinyConv")
        ssn_test.main(["thumos14", "RGB", "s.pt", "det.pkl", "--arch",
                       "TinyConv", "--synthetic_data", "--prop_file_dir", d,
                       "--device", "cpu", "--test_batchsize", "8"])
        reset_launch_counts()
        ap = eval_detection_results.main(["thumos14", "det.pkl", "det.pkl",
                                          "--score_weights", "1", "1.5",
                                          "--prop_file_dir", d, "-j", "2"])
        assert ap.shape == (20, 9) and np.isfinite(ap).all()
        assert launch_counts()["host_nms"] > 0
        assert not os.path.exists("gt_dump.pc")

        # one model as .pt, JAX msgpack and reference .pth.tar
        pickles = []
        for name in ("w.pt", "w.msgpack", "w.pth.tar"):
            ssn_test.main(["thumos14", "RGB",
                           os.path.join(os.environ["ADT_WEIGHTS_DIR"], name),
                           name + ".pkl", "--arch", "TinyConv",
                           "--synthetic_data", "--prop_file_dir", d,
                           "--device", "cpu", "--test_batchsize", "8"])
            with open(name + ".pkl", "rb") as f:
                pickles.append(pickle.load(f))
        for other in pickles[1:]:
            assert set(other) == set(pickles[0])
            for vid, arrays in pickles[0].items():
                assert all(np.array_equal(a, b)
                           for a, b in zip(arrays, other[vid]))

        with open("thumos14_tag_val_normalized_proposal_list.txt", "w") as f:
            f.write("# 0\\nvideo_validation_0001\\n60.0\\n3\\n1\\n"
                    "1 0.1667 0.3667\\n1\\n1 0.7000 0.8000 0.1500 0.4000\\n")
        gen_proposal_list.main(["thumos14", frames, "--data_dir", d])
        (g,) = load_proposal_file("thumos14_tag_val_proposal_list.txt")
        assert g[1] == 180 and g[2] == [["1", "30", "66"]], g
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("PIPELINE-OK")
""")


TRAINING = BLOCK + textwrap.dedent("""
    import os, tempfile
    import numpy as np

    from action_detection_torch.cli import binary_train, ssn_train

    def write_list(path, n_videos):
        # fg, incomplete and background proposals around two GT instances
        lines = []
        for v in range(n_videos):
            gt = [(1 + v % 3, 100, 300), (1 + (v + 1) % 3, 400, 520)]
            props = [(g[0], 0.85, 0.9, g[1] - 20, g[2] + 5) for g in gt]
            props += [(g[0], 0.2, 0.9, g[1] + 30, g[1] + 110) for g in gt]
            props += [(g[0], 0.15, 0.85, g[1] + 50, g[1] + 130) for g in gt]
            props += [(0, 0.0, 0.0, 530, 595), (0, 0.005, 0.0, 10, 90)]
            lines.append(f"# {v}\\nvideo_{v}\\n600\\n1\\n{len(gt)}\\n")
            lines += [f"{g[0]} {g[1]} {g[2]}\\n" for g in gt]
            lines.append(f"{len(props)}\\n")
            lines += [f"{p[0]} {p[1]:.4f} {p[2]:.4f} {p[3]} {p[4]}\\n"
                      for p in props]
        with open(path, "w") as f:
            f.writelines(lines)

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        for task in ("tag", "sw"):
            write_list(f"thumos14_{task}_val_proposal_list.txt", 3)
            write_list(f"thumos14_{task}_test_proposal_list.txt", 2)
        common = ["thumos14", "RGB", "--arch", "TinyConv", "--synthetic_data",
                  "--device", "cpu", "-j", "1", "--epochs", "1", "-b", "2",
                  "--prop_file_dir", d]
        stats = ssn_train.main(common + ["--tem", "1"])
        ckpt = "ssn_thumos14_TinyConv_rgb_checkpoint.pt"
        assert len(stats.step_ms) == 1 and os.path.exists(ckpt)
        assert np.isfinite(stats.best_loss)
        ev = ssn_train.main(common + ["--evaluate", "--resume", ckpt])
        assert ev.val_losses == [stats.best_loss] and not ev.step_ms
        b = binary_train.main(common)
        assert len(b.step_ms) == 1
        assert os.path.exists("ssn_thumos14_TinyConv_rgb_binary_checkpoint.pt")
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("TRAINING-OK")
""")

PROPS = textwrap.dedent("""
    def write_list(path, n_videos):
        # fg, incomplete and background proposals around two GT instances
        lines = []
        for v in range(n_videos):
            gt = [(1 + v % 3, 100, 300), (1 + (v + 1) % 3, 400, 520)]
            props = [(g[0], 0.85, 0.9, g[1] - 20, g[2] + 5) for g in gt]
            props += [(g[0], 0.2, 0.9, g[1] + 30, g[1] + 110) for g in gt]
            props += [(g[0], 0.15, 0.85, g[1] + 50, g[1] + 130) for g in gt]
            props += [(0, 0.0, 0.0, 530, 595), (0, 0.005, 0.0, 10, 90)]
            lines.append(f"# {v}\\nvideo_{v}\\n600\\n1\\n{len(gt)}\\n")
            lines += [f"{g[0]} {g[1]} {g[2]}\\n" for g in gt]
            lines.append(f"{len(props)}\\n")
            lines += [f"{p[0]} {p[1]:.4f} {p[2]:.4f} {p[3]} {p[4]}\\n"
                      for p in props]
        with open(path, "w") as f:
            f.writelines(lines)
""")

PERLAYER = BLOCK + PROPS + textwrap.dedent("""
    import os, tempfile
    import numpy as np

    from action_detection_torch.cli import ssn_test
    from action_detection_torch.data.pipeline import (
        SyntheticFrameProvider, collect_calibration_frames,
        make_test_transform)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.models.backbones import InputSpec

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        write_list("p.txt", 1)
        ds = SSNDataset("p.txt", test_interval=150)
        provider = SyntheticFrameProvider(width=97, height=73)
        model = seeded_init(SSN(num_class=20, dropout=0.0), seed=0)
        base = model.input_spec
        spec = InputSpec(64, base.mean, base.std, base.bgr, base.div255)
        calib = collect_calibration_frames(
            ds, provider, make_test_transform(64, spec.scale_size, 10))
        for frames in (calib, None):
            with ProposalScorer(model, spec, reg_stats=np.ones((2, 2)),
                                num_class=20, chunk_frames=4, device="cpu",
                                quantize="perlayer",
                                calibration_frames=frames) as scorer:
                assert (scorer._act_scales is None) == (frames is None)
                out = scorer.score_video(ds.get_test_sample(0), provider)
            assert out.act_scores.shape == (8, 21)
            assert np.isfinite(out.act_scores).all()
        try:
            ssn_test.main(["thumos14", "RGB", "w.pt", "s.pkl", "--arch",
                           "InceptionV3", "--int8_mode", "perlayer",
                           "--device", "cpu"])
        except SystemExit as e:
            assert "'perlayer' is not available" in str(e), e
        else:
            raise AssertionError("InceptionV3 perlayer was not refused")
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("PERLAYER-OK")
""")

RGBDIFF = BLOCK + PROPS + textwrap.dedent("""
    import os, tempfile
    import numpy as np

    from action_detection_torch.cli import binary_train, ssn_train
    from action_detection_torch.data.pipeline import SyntheticFrameProvider
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.models.backbones import InputSpec

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        for task in ("tag", "sw"):
            write_list(f"thumos14_{task}_val_proposal_list.txt", 3)
            write_list(f"thumos14_{task}_test_proposal_list.txt", 2)
        ds = SSNDataset("thumos14_tag_test_proposal_list.txt",
                        new_length=5, test_interval=150)
        model = seeded_init(SSN(num_class=20, modality="RGBDiff",
                                dropout=0.0), seed=0)
        base = model.input_spec
        spec = InputSpec(64, base.mean, base.std, base.bgr, base.div255)
        provider = SyntheticFrameProvider(97, 73, modality="RGBDiff")
        with ProposalScorer(model, spec, reg_stats=np.ones((2, 2)),
                            num_class=20, chunk_frames=4, modality="RGBDiff",
                            device="cpu", quantize="e2e",
                            shared_stem=True) as scorer:
            out = scorer.score_video(ds.get_test_sample(0), provider)
        assert out.act_scores.shape == (8, 21)
        assert np.isfinite(out.act_scores).all()
        common = ["thumos14", "RGBDiff", "--arch", "TinyConv",
                  "--synthetic_data", "--device", "cpu", "-j", "1",
                  "--epochs", "1", "-b", "2", "--prop_file_dir", d]
        stats = ssn_train.main(common + ["--tem", "1"])
        assert len(stats.step_ms) == 1 and np.isfinite(stats.best_loss)
        assert os.path.exists("ssn_thumos14_TinyConv_rgbdiff_checkpoint.pt")
        b = binary_train.main(common)
        assert len(b.step_ms) == 1 and np.isfinite(b.best_loss)
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("RGBDIFF-OK")
""")

HOST_CROPS = BLOCK + PROPS + textwrap.dedent("""
    import os, pickle, tempfile
    import numpy as np

    from action_detection_torch.cli import binary_test, ssn_test
    from action_detection_torch.models import (SSN, BinaryClassifier,
                                               seeded_init)
    from action_detection_torch.train import save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        write_list("thumos14_tag_test_proposal_list.txt", 2)
        write_list("thumos14_sw_test_proposal_list.txt", 2)
        save_checkpoint("s.pt", seeded_init(SSN(
            num_class=20, base_model="TinyConv"), seed=1).state_dict(),
            np.array([[0.0, 0.0], [0.1, 0.1]]), arch="TinyConv")
        save_checkpoint("b.pt", seeded_init(BinaryClassifier(
            base_model="TinyConv"), seed=0).state_dict(), None,
            arch="TinyConv")
        common = ["--arch", "TinyConv", "--synthetic_data",
                  "--prop_file_dir", d, "--device", "cpu",
                  "--test_batchsize", "8", "--frame_interval", "60"]
        res = ssn_test.main(["thumos14", "RGB", "s.pt", "s.pkl",
                             "--test_crops", "1"] + common)
        assert len(res) == 2
        for flags, crops in ((["--host_crops"], 10),
                             (["--test_crops", "1"], 1)):
            act = binary_test.main(["thumos14", "RGB", "testing", "b.pt",
                                    "a.pkl"] + common + flags)
            assert all(a.shape == (10, crops, 2) and np.isfinite(a).all()
                       for a in act.values()), flags
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("HOST-CROPS-OK")
""")


def _run(script: str, **env_extra) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


# one torch thread in these subprocesses: the suite runs on several
# workers at once (see test_torch_port_int8.py:one_torch_thread)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def test_port_imports_and_scores_without_jax_flax_yaml_pil():
    out = _run(SCRIPT, **ONE_THREAD)
    last = out.strip().splitlines()[-1]
    assert last.startswith("ISOLATED-OK"), out
    assert int(last.split()[1]) >= 25      # every module was imported


def _weights(d: str) -> str:
    """One TinyConv SSN as the port's .pt, the JAX package's msgpack (its
    own writer, flax) and a reference-style .pth.tar (``module.`` keys,
    numpy reg_stats)."""
    import numpy as np
    import torch

    from action_detection_tpu.models.convert import (
        convert_torch_ssn_checkpoint)
    from action_detection_tpu.train import save_checkpoint as jax_save

    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import save_checkpoint

    model = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=2)
    rs = np.array([[0.0, 0.0], [0.1, 0.1]], np.float32)
    save_checkpoint(os.path.join(d, "w.pt"), model.state_dict(), rs,
                    arch="TinyConv")
    ck = convert_torch_ssn_checkpoint({"state_dict": model.state_dict()},
                                      "TinyConv")
    jax_save(os.path.join(d, "w.msgpack"), ck["params"], rs,
             batch_stats=ck["batch_stats"], arch="TinyConv")
    torch.save({"state_dict": {"module." + k: v for k, v in
                               model.state_dict().items()},
                "reg_stats": rs, "arch": "TinyConv", "epoch": 1},
               os.path.join(d, "w.pth.tar"))
    return d


RANK = BLOCK + textwrap.dedent("""
    from action_detection_torch.cli import ssn_train

    ssn_train.main(sys.argv[1:])
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
""")

DATA_PARALLEL = BLOCK + PROPS + textwrap.dedent("""
    import os, re, subprocess, tempfile

    from action_detection_torch.parallel import free_port

    with tempfile.TemporaryDirectory() as d:
        write_list(os.path.join(d, "thumos14_tag_val_proposal_list.txt"), 2)
        write_list(os.path.join(d, "thumos14_tag_test_proposal_list.txt"), 2)
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, "thumos14", "RGB", "--arch",
             "TinyConv", "--synthetic_data", "--device", "cpu", "-j", "1",
             "--epochs", "1", "-b", "2", "--tem", "2", "--prop_file_dir", d,
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(i)], cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        try:
            outs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        losses = [re.search(r"losses (\\[.*\\])", out).group(1)
                  for out in outs]
        assert losses[0] == losses[1], losses
        assert os.path.exists(os.path.join(
            d, "ssn_thumos14_TinyConv_rgb_checkpoint.pt"))
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("DATA-PARALLEL-OK")
""")


def test_pipeline_clis_without_jax_flax_yaml_pil_sklearn_pandas(tmp_path):
    out = _run(PIPELINE, ADT_WEIGHTS_DIR=_weights(str(tmp_path)),
               **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "PIPELINE-OK", out
    assert "gt_dump.pc and pred_dump.pc skipped" in out
    assert "Detection Performance on thumos14" in out


def test_training_clis_without_jax_flax_optax_yaml_pil():
    out = _run(TRAINING, **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "TRAINING-OK", out
    assert "Testing Results: Loss" in out and "checkpoint saved" in out


def test_perlayer_scoring_without_jax_flax_yaml_pil():
    out = _run(PERLAYER, **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "PERLAYER-OK", out


def test_rgbdiff_scoring_and_training_without_jax_flax_optax_yaml_pil():
    out = _run(RGBDIFF, **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "RGBDIFF-OK", out


def test_host_crop_scoring_without_jax_flax_yaml_pil():
    out = _run(HOST_CROPS, **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "HOST-CROPS-OK", out


def test_data_parallel_training_without_jax_flax_optax_yaml_pil():
    """``action_detection_torch.parallel`` and a 2-rank ``ssn_train``
    (two processes on gloo through the multi-host flags, each under the
    same blocks) run with jax, flax, optax, yaml and PIL unimportable."""
    script = DATA_PARALLEL.replace("RANK_SCRIPT", repr(RANK))
    out = _run(script, **ONE_THREAD)
    assert out.strip().splitlines()[-1] == "DATA-PARALLEL-OK", out
