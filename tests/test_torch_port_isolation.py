"""The port runs on a machine without jax, flax, optax, orbax, yaml, PIL,
scikit-learn, pandas, msgpack or tensorstore.

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
flags, each under the blocks. And one scores JPEG frame directories (links to
the committed fixtures) through ``ssn_test`` on the port's decoder; its
pickle equals that of the same run in the test process on PIL's decode.
One decodes the PNG, BMP and PNM fixtures and a directory of such frames
and meets the orbax writer's refusal; one runs the twin THUMOS14 recipe
with the blocks in every process it starts; and one reads the sources:
no module of the port, no twin script and nothing ``chip_smoke.py``
imports imports jax, PIL or the JAX package."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL",
           "sklearn", "pandas", "msgpack", "tensorstore")
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


JPEG_SCORING = BLOCK + textwrap.dedent("""
    from action_detection_torch.cli import ssn_test
    from action_detection_torch.kernels import launch_counts

    ssn_test.main(sys.argv[1:])
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("JPEG-OK", launch_counts()["host_jpeg_decode"])
""")


def test_jpeg_scoring_without_pil_equals_pil_frames(tmp_path, monkeypatch):
    """``ssn_test`` (TinyConv, float path) on JPEG frame directories with
    PIL and the rest blocked, through the port's decoder: the pickle of
    the same run in this process with the provider on PIL's decode
    (tests/test_torch_port_jpeg.py:load_with_pil); one decode per frame
    load."""
    import pickle

    import numpy as np
    import torch

    from action_detection_torch.cli import ssn_test
    from action_detection_torch.data.pipeline import DirectoryFrameProvider

    from tests.test_datasets import write_proposal_list
    from tests.test_torch_port_jpeg import link_frames, load_with_pil

    d = str(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, frames_per_video=240, seed=7)
    for vid in ("video_0", "video_1"):
        link_frames(os.path.join(d, "frames"), vid, 240, "RGB")
    _weights(d)
    argv = ["thumos14", "RGB", os.path.join(d, "w.pt"), "PKL", "--arch",
            "TinyConv", "--data_root", os.path.join(d, "frames"),
            "--prop_file_dir", d, "--device", "cpu", "--frame_interval",
            "10", "--test_batchsize", "8"]
    proc_argv = [a if a != "PKL" else os.path.join(d, "blocked.pkl")
                 for a in argv]
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", JPEG_SCORING, *proc_argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("JPEG-OK"), proc.stdout

    loads = []

    def counted(provider, video_id, idx):
        loads.append(idx)
        return load_with_pil(provider, video_id, idx)

    monkeypatch.setattr(DirectoryFrameProvider, "load", counted)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ssn_test.main([a if a != "PKL" else os.path.join(d, "pil.pkl")
                       for a in argv])
    finally:
        torch.set_num_threads(threads)
    with open(os.path.join(d, "blocked.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(d, "pil.pkl"), "rb") as f:
        want = pickle.load(f)
    assert set(got) == set(want) and len(got) == 2
    for vid in want:
        for g, w in zip(got[vid], want[vid]):
            np.testing.assert_array_equal(g, w)
    # one decode per RGB frame load: 24 ticks of 10 frames a video
    assert int(last.split()[1]) == len(loads) == 48


FRAMES = BLOCK + textwrap.dedent("""
    import hashlib, json, os, tempfile
    import numpy as np
    from action_detection_torch.data.image import decode_image
    from action_detection_torch.data.jpeg import decode_jpeg
    from action_detection_torch.data.pipeline import DirectoryFrameProvider
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.train.checkpoint import save_checkpoint_orbax
    from tests.frame_encoders import bmp_bytes, png_rgb, ppm_rgb

    root = os.path.join("tests", "fixtures", "torch_port_frames")
    with open(os.path.join(root, "digests.json")) as f:
        digests = json.load(f)
    n = 0
    for name, modes in digests.items():
        for mode, want in modes.items():
            a = decode_image(os.path.join(root, name), mode)
            assert {"shape": list(a.shape), "sha256": hashlib.sha256(
                a.tobytes()).hexdigest()} == want, (name, mode)
            n += 1
    jpegs = os.path.join("tests", "fixtures", "torch_port_jpeg")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "v"))
        for i, enc in enumerate((png_rgb, lambda a: bmp_bytes(a, 24),
                                 ppm_rgb), 1):
            rgb = decode_jpeg(os.path.join(jpegs, f"img_{i:05d}.jpg"))
            with open(os.path.join(d, "v", f"img_{i:05d}.jpg"), "wb") as f:
                f.write(enc(rgb))
            got = DirectoryFrameProvider(d).load("v", i)[0]
            assert np.array_equal(got, rgb), i
        try:
            save_checkpoint_orbax(os.path.join(d, "ck"), {}, np.zeros(4))
        except ImportError as e:
            assert "tensorstore" in str(e), e
        else:
            raise AssertionError("an orbax write without tensorstore")
    counts = launch_counts()
    assert [counts[f"host_{k}_decode"] for k in ("jpeg", "png", "bmp",
                                                 "pnm")] == [3, 1, 1, 1], counts
    leaked = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
    assert not leaked, leaked
    print("FRAMES-OK", n)
""")


def test_frame_formats_and_orbax_writer_without_jax_pil_tensorstore():
    """The PNG, BMP and PNM decoder with PIL (and the rest) blocked: every
    committed fixture to PIL's digests, a frame directory of PNG, BMP and
    PPM files through ``DirectoryFrameProvider``, and the orbax writer's
    refusal naming tensorstore."""
    out = _run(FRAMES, **ONE_THREAD)
    last = out.strip().splitlines()[-1]
    assert last.startswith("FRAMES-OK"), out
    assert int(last.split()[1]) > 200


def test_twin_recipe_without_jax_flax_yaml_pil(tmp_path):
    """``action_detection_torch/scripts/reproduce_thumos14.sh`` run by
    ``bash`` end to end (TinyConv on the CPU through the recipes' shim)
    with jax, flax, yaml, PIL and the rest blocked in every Python process
    it starts (a ``sitecustomize`` on ``PYTHONPATH``)."""
    from tests.recipe_db import (recipe_steps, write_flow_init,
                                 write_python_shim, write_recipe_db)

    block_dir = tmp_path / "block"
    block_dir.mkdir()
    (block_dir / "sitecustomize.py").write_text(BLOCK)
    work = str(tmp_path / "work")
    write_recipe_db(work, str(tmp_path / "frames"), "thumos14")
    small = ["--arch", "TinyConv", "--device", "cpu"]
    write_python_shim(str(tmp_path / "bin"), {
        ("port", "ssn_train"): small + ["--epochs", "1", "-b", "2", "--tem",
                                        "1", "-j", "1"],
        ("port", "ssn_test"): small + ["--frame_interval", "30"],
        ("port", "eval_detection_results"): ["-j", "1"]},
        rename=("BNInception", "TinyConv"))
    write_flow_init(str(tmp_path / "flow_init.pth"), "TinyConv")
    env = dict(os.environ, PYTHONPATH=f"{block_dir}{os.pathsep}{ROOT}",
               PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}",
               FLOW_INIT=str(tmp_path / "flow_init.pth"), **ONE_THREAD)
    proc = subprocess.run(
        ["bash", os.path.join(ROOT, "action_detection_torch", "scripts",
                              "reproduce_thumos14.sh"),
         str(tmp_path / "frames")], cwd=work, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert [s["cli"] for s in recipe_steps(proc.stdout)] == [
        "gen_proposal_list", "ssn_train", "ssn_train", "ssn_test",
        "ssn_test", "eval_detection_results"]
    assert os.path.isfile(os.path.join(work, "work_thumos14",
                                       "scores_flow.pkl"))


#: what no module of the port, no twin script and nothing chip_smoke.py
#: imports may import
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL",
           "action_detection_tpu")


def test_port_scripts_and_chip_smoke_import_nothing_foreign():
    """Every module of ``action_detection_torch``, ``chip_smoke.py`` and
    the test helpers it imports (``tests/frame_encoders.py``,
    ``tests/recipe_db.py``) import none of :data:`FOREIGN`, at any depth
    of the file; the twin recipes call only the port's CLIs."""
    import ast
    import glob

    files = (glob.glob(os.path.join(ROOT, "action_detection_torch", "**",
                                    "*.py"), recursive=True)
             + [os.path.join(ROOT, "chip_smoke.py"),
                os.path.join(ROOT, "tests", "frame_encoders.py"),
                os.path.join(ROOT, "tests", "recipe_db.py")])
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(
                         node, ast.ImportFrom) and not node.level else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in FOREIGN]
    assert not bad, bad
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        smoke = f.read()
    assert "tests.frame_encoders" in smoke and "tests.recipe_db" in smoke
    for script in glob.glob(os.path.join(ROOT, "action_detection_torch",
                                         "scripts", "*.sh")):
        with open(script) as f:
            text = f.read()
        assert "action_detection_tpu" not in text, script
        calls = [line.split()[1:3] for line in text.splitlines()
                 if line.startswith("python ")]
        assert calls and all(c[0] == "-m" and c[1].startswith(
            "action_detection_torch.cli.") for c in calls), script
