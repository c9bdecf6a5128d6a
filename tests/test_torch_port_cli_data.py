"""The port's data subcommands (a3gc_tpu_torch.cli ``preprocess``,
``convert-data``, ``worst-frames``) against the JAX CLI's on the CPU: the
parsers (every flag and default; the port adds ``--device`` alone),
``preprocess --device cpu`` of every corpus under ``--data_root`` against
the JAX CLI's npz and stdout, ``convert_torch_dataset`` and ``convert-data``
on both reference layouts with and without positions, ``worst-frames`` with
and without ``--render`` against the JAX CLI's files and stdout, and the
factory's packed output through the port's StageRunner.

Sizes: a synthetic SMPL body of 6890 vertices (160 for worst-frames), raw
sequences of at most 600
frames (one 3,560-frame TotalCapture file, dropped as faulty), hidden 8.
Tolerances: 1e-5 on rotations, positions and poses, 1e-4 on normalized
accelerations; the rest bit-equal; rendered PNGs
at most 0.1 % of pixels apart (FK rounding may move an edge pixel)."""

import contextlib
import dataclasses
import io
import os
import pickle

import numpy as np
import pytest
import torch

import a3gc_tpu.config as JCFG
from a3gc_tpu import cli as JCLI
from a3gc_tpu.compat.torch_data import convert_torch_dataset as jax_convert
from a3gc_tpu.data.factory import amass as JA
from a3gc_tpu.data.factory import dipimu as JD
from a3gc_tpu.data.factory import totalcapture as JT
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch import config as TCFG
from a3gc_tpu_torch.compat.torch_data import convert_torch_dataset
from a3gc_tpu_torch.data import pipeline as TDP
from a3gc_tpu_torch.smpl import write_synthetic_smpl_pickle

from torch_port_oracle import random_rotations
from torch_port_raw import (FACTORY_TOL, ROT_POS_TOL, write_raw_amass,
                            write_raw_dip, write_raw_totalcapture)

torch.set_num_threads(1)

PIXEL_SHARE = 1e-3


@pytest.mark.parametrize("command,argv", [
    ("preprocess", ["--dataset", "amass", "--output", "o.npz"]),
    ("preprocess", ["--dataset", "dipimu", "--split", "test", "--output",
                    "o.npz", "--cda", "--smpl", "s.pkl", "--data_root", "d",
                    "--model", "dip", "--hu1", "8", "--hu2", "4", "--hu3",
                    "2", "--norm", "--rotsize", "6", "--precision",
                    "highest", "--profile", "p", "--debug_nans",
                    "--compilation_cache", "c"]),
    ("preprocess", ["--dataset", "totalcapture", "--split", "valid",
                    "--output", "o.npz"]),
    ("worst-frames", ["--gt", "g", "--pred_a", "a", "--pred_b", "b"]),
    ("worst-frames", ["--gt", "g", "--pred_a", "a", "--pred_b", "b", "--k",
                      "3", "--min_separation", "50", "--output", "out",
                      "--render", "--smpl", "s.pkl", "--model", "tp"]),
    ("convert-data", ["--torch", "x.pt", "--output", "y.npz"]),
    ("convert-data", ["--torch", "x.pt", "--output", "y.npz",
                      "--compilation_cache", "c"]),
])
def test_torch_port_cli_data_flags_match_jax_cli(command, argv):
    ours = vars(TCLI.build_parser().parse_args([command] + argv))
    ref = vars(JCLI.build_parser().parse_args([command] + argv))
    fn = ours.pop("fn")
    assert fn is {"preprocess": TCLI.cmd_preprocess,
                  "worst-frames": TCLI.cmd_worst_frames,
                  "convert-data": TCLI.cmd_convert_data}[command]
    ref.pop("fn")
    assert ours.pop("command") == ref.pop("cmd") == command
    if command != "convert-data":
        assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.mark.parametrize("argv", [
    ["preprocess", "--output", "o"],
    ["preprocess", "--dataset", "h36m", "--output", "o"],
    ["preprocess", "--dataset", "amass"],
    ["worst-frames", "--gt", "g", "--pred_a", "a"],
    ["convert-data", "--torch", "x.pt"],
])
def test_torch_port_cli_data_refuses_what_jax_cli_refuses(argv, capsys):
    for cli in (TCLI, JCLI):
        with pytest.raises(SystemExit) as e:
            cli.build_parser().parse_args(argv)
        assert e.value.code == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

RUNS = {"amass": ["--dataset", "amass", "--split", "train", "--cda"],
        "amass_valid": ["--dataset", "amass", "--split", "valid"],
        "dip_train": ["--dataset", "dipimu", "--split", "train"],
        "dip_test": ["--dataset", "dipimu", "--split", "test"],
        "tc": ["--dataset", "totalcapture"]}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """Both CLIs' ``preprocess`` of every run of RUNS on one data root:
    {run: ((port npz, stdout), (JAX npz, stdout))}. The JAX factories read
    the data root of their import, so its run patches their paths."""
    root = str(tmp_path_factory.mktemp("data_root"))
    out = tmp_path_factory.mktemp("out")
    paths = TCFG.Paths(data_root=root)
    # one length a corpus where the oracle runs FK (JAX compiles every op
    # for every new shape)
    write_raw_amass(paths.resolve(paths.raw_amass_dir), (
        ("CMU", "01", "walk", 600, 120), ("KIT", "2", "hop", 300, 59),
        ("KIT", "2", "skip", 400, 100), ("SFU", "0005", "run", 300, 60)))
    write_raw_dip(paths.resolve(paths.raw_dipimu_dir), (
        ("s_01", "01", 400, "burst"), ("s_01", "05", 400, None),
        ("s_09", "02", 400, "burst"), ("s_10", "01", 400, None)))
    write_raw_totalcapture(paths.resolve(paths.raw_totalcapture_dir), (
        ("s1_acting1", 320, 324), ("s4_freestyle3", 3560, 3560)))
    # the CLI synthesizes at AMASS_VI_MASK: SMPL's vertex count
    smpl = write_synthetic_smpl_pickle(os.path.join(root, "smpl.pkl"),
                                       n_vertices=6890)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        jpaths = dataclasses.replace(JCFG.paths, data_root=root)
        mp.setattr(JCFG, "paths", jpaths)
        for mod in (JA, JD, JT):
            mp.setattr(mod, "default_paths", jpaths)
        mp.setenv("A3GC_DATA_ROOT", root)          # the JAX main sets it
        for name, argv in RUNS.items():
            argv = ["preprocess"] + argv + ["--smpl", smpl]
            ours = str(out / f"{name}_ours.npz")
            ref = str(out / f"{name}_ref.npz")
            got = _run(TCLI.main, argv + ["--device", "cpu", "--output",
                                          ours, "--data_root", root])
            want = _run(JCLI.main, argv + ["--output", ref, "--data_root",
                                           root])
            runs[name] = ((ours, got), (ref, want))
    return runs


@pytest.mark.parametrize("run", sorted(RUNS))
def test_torch_port_cli_preprocess_matches_jax_cli(preprocessed, run):
    (ours, got), (ref, want) = preprocessed[run]
    assert got.replace(ours, "<npz>") == want.replace(ref, "<npz>")
    n = {"amass": 2 * (1 + 1), "amass_valid": 1, "dip_train": 1,
         "dip_test": 2, "tc": 1}[run]
    assert f": {n} " in got
    with np.load(ours) as g, np.load(ref) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            field = "acc" if k.endswith("acc") else k
            np.testing.assert_allclose(
                g[k], w[k], rtol=0,
                atol=FACTORY_TOL.get(field, ROT_POS_TOL), err_msg=k)


def test_torch_port_factory_output_feeds_the_port_trainer(preprocessed):
    """The AMASS chunks of ``cli preprocess`` through the port's training
    feed and StageRunner (stage 1, A3GC at hidden 8): an epoch's loss (on
    the chunks' first 60 frames) and the validation loss are finite, as JAX's ``test_factory_feeds_training``
    holds its trainer (``test_torch_port_train.py`` holds the losses to
    JAX's)."""
    from a3gc_tpu_torch.config import TrainConfig
    from a3gc_tpu_torch.data import load_adjacency_template
    from a3gc_tpu_torch.models import nets as N
    from a3gc_tpu_torch.models.pipeline import PoseNetConfig, init_pose_net
    from a3gc_tpu_torch.train import StageRunner

    (ours, _), _ = preprocessed["amass"]
    packed = TDP.load_packed(ours)
    assert packed["ori"].shape == (4, 300, 54)
    cfg = PoseNetConfig(net=N.GraphNetConfig(
        cell="a3gc", units_in=12, units_out=3, units_hidden=8), rotsize=3)
    params = init_pose_net(torch.Generator().manual_seed(0), cfg,
                           load_adjacency_template())
    runner = StageRunner(1, cfg, params, TrainConfig(batch_size=2),
                         steps_per_epoch=1, device="cpu")
    # the training scan's plain path, a loop of small ops a frame: 60 frames
    short = {k: v[:, :60] for k, v in packed.items()}
    assert np.isfinite(runner.train_epoch(TDP.Sampler(short, 2), seed=0))
    assert np.isfinite(runner.eval_epoch(TDP.Sampler(packed, 4,
                                                     shuffle=False)))


# ---------------------------------------------------------------------------
# convert-data
# ---------------------------------------------------------------------------

def _reference_sets(rng):
    """The reference's packed layouts: stacked training chunks (torch
    tensors, or numpy for ori) and per-sequence test lists, with and without
    positions."""
    N, T = 3, 20
    stacked = {"acc": torch.as_tensor(rng.normal(size=(N, T, 6, 3))),
               "ori": random_rotations(rng, (N, T, 6)).reshape(N, T, 6, 3, 3),
               "pose": torch.as_tensor(random_rotations(rng, (N, T, 15)))}
    with_pos = dict(stacked,
                    ori=torch.as_tensor(stacked["ori"]),
                    full_pos=torch.as_tensor(rng.normal(size=(N, T, 72))),
                    leaf_pos=torch.as_tensor(rng.normal(size=(N, T, 5, 3))))
    lengths = (7, 12)
    lists = {"acc": [torch.as_tensor(rng.normal(size=(n, 18)))
                     for n in lengths],
             "ori": [torch.as_tensor(random_rotations(rng, (n, 6)))
                     for n in lengths],
             "pose": [torch.as_tensor(random_rotations(rng, (n, 15))
                                      ).reshape(n, 15, 3, 3)
                      for n in lengths]}
    lists_pos = dict(lists,
                     full_pos=[torch.as_tensor(rng.normal(size=(n, 24, 3)))
                               for n in lengths],
                     leaf_pos=[torch.as_tensor(rng.normal(size=(n, 15)))
                               for n in lengths])
    return {"stacked": stacked, "stacked_pos": with_pos, "lists": lists,
            "lists_pos": lists_pos}


@pytest.mark.parametrize("layout", ["stacked", "stacked_pos", "lists",
                                    "lists_pos"])
def test_torch_port_convert_data_matches_jax(tmp_path, layout, capsys):
    data = _reference_sets(np.random.default_rng(30))[layout]
    pt = str(tmp_path / f"{layout}.pt")
    torch.save(data, pt)
    ours = convert_torch_dataset(pt, str(tmp_path / "a" / "ours.npz"))
    ref = jax_convert(pt, str(tmp_path / "b" / "ref.npz"))
    TCLI.main(["convert-data", "--torch", pt, "--output",
               str(tmp_path / "c" / "cli.npz")])
    JCLI.main(["convert-data", "--torch", pt, "--output",
               str(tmp_path / "c" / "cli.npz")])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and printed[0] == printed[1]
    kind = "test (per-sequence)" if layout.startswith("lists") \
        else "train (packed)"
    assert f"[{kind}, " in printed[0]
    with np.load(ours) as g, np.load(ref) as w, \
            np.load(tmp_path / "c" / "cli.npz") as c:
        assert sorted(g.files) == sorted(w.files) == sorted(c.files)
        for k in w.files:
            assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(c[k], w[k])
        if layout.startswith("stacked"):
            assert g["ori"].shape == (3, 20, 54)
            assert g["acc"].shape == (3, 20, 18)
            assert g["pose"].shape == (3, 20, 135)
            assert ("full_pos" in g.files) == layout.endswith("pos")
            if layout.endswith("pos"):
                assert g["full_pos"].shape == (3, 20, 24, 3)
                np.testing.assert_array_equal(
                    g["leaf_pos"], data["leaf_pos"].numpy().astype(
                        np.float32))
        else:
            assert g["seq1_ori"].shape == (12, 54)
            assert g["seq0_pose"].shape == (7, 135)
            assert ("seq1_leaf_pos" in g.files) == layout.endswith("pos")
            if layout.endswith("pos"):
                assert g["seq1_leaf_pos"].shape == (12, 5, 3)
            np.testing.assert_array_equal(
                g["seq1_acc"], data["acc"][1].numpy().astype(np.float32))


def test_torch_port_convert_data_refuses_other_files(tmp_path):
    pt = str(tmp_path / "x.pt")
    torch.save({"state_dict": {}}, pt)
    with pytest.raises(AssertionError, match="not a reference packed"):
        convert_torch_dataset(pt, str(tmp_path / "x.npz"))


# ---------------------------------------------------------------------------
# worst-frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Per-sequence pose dumps in the layout ``evaluate --save_preds``
    writes (``{gt,pred}/NNN.p``, local rotations [T, 24, 3, 3]): ground
    truth and two models' predictions, and a synthetic SMPL pickle."""
    root = tmp_path_factory.mktemp("dumps")
    rng = np.random.default_rng(31)
    for sub, noise in (("gt", 0.0), ("a", 0.2), ("b", 0.05)):
        os.makedirs(root / sub)
        for i, T in enumerate((400, 300)):
            base = random_rotations(np.random.default_rng(i), (T, 24))
            pose = base.reshape(T, 24, 3, 3) + noise * rng.normal(
                size=(T, 24, 3, 3)).astype(np.float32)
            with open(root / sub / f"{i:03d}.p", "wb") as f:
                pickle.dump(pose, f)
    smpl = write_synthetic_smpl_pickle(str(root / "smpl.pkl"),
                                       n_vertices=160)
    return root, smpl


@pytest.mark.parametrize("render", [False, True])
def test_torch_port_cli_worst_frames_matches_jax_cli(dumps, tmp_path,
                                                     render):
    root, smpl = dumps
    argv = ["worst-frames", "--smpl", smpl, "--gt", str(root / "gt"),
            "--pred_a", str(root / "a"), "--pred_b", str(root / "b"), "--k",
            "2", "--min_separation", "100"] + (["--render"] if render else [])
    got = _run(TCLI.main, argv + ["--device", "cpu", "--output",
                                  str(tmp_path / "ours")])
    want = _run(JCLI.main, argv + ["--output", str(tmp_path / "ref")])
    assert got == want and len(got.splitlines()) == 6
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref")
                   for d, _, fs in os.walk(tmp_path / "ref") for f in fs)
    assert names == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "ours")
        for d, _, fs in os.walk(tmp_path / "ours") for f in fs)
    pickles = [n for n in names if n.endswith(".p")]
    pngs = [n for n in names if n.endswith(".png")]
    assert len(pickles) == 6 + 18 and len(pngs) == (12 if render else 0)
    for name in pickles:
        with open(tmp_path / "ours" / name, "rb") as f:
            x = pickle.load(f)
        with open(tmp_path / "ref" / name, "rb") as f:
            y = pickle.load(f)
        if isinstance(y, dict):
            assert x.keys() == y.keys()
            for k in y:
                np.testing.assert_allclose(np.asarray(x[k]), np.asarray(y[k]),
                                           rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(x, y)
    from PIL import Image
    for name in pngs:
        x = np.asarray(Image.open(tmp_path / "ours" / name))
        y = np.asarray(Image.open(tmp_path / "ref" / name))
        assert x.shape == y.shape == (360, 360, 3)
        assert (x != y).any(-1).mean() <= PIXEL_SHARE, name
