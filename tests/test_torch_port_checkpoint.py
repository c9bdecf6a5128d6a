"""Checkpoint interop of the port against the JAX package on the CPU:
``a3gc_tpu_torch.compat.torch_import`` / ``torch_export`` against
``a3gc_tpu.compat``'s both ways (bit for bit, every family: a3gc, aagc,
agc, ggru, tp, dip and the unidirectional dip), ``.tar`` files written by
either side read by the other, ``a3gc_tpu_torch.utils`` discovery against
``a3gc_tpu.utils.discover_latest`` on directory trees, the port's own
checkpoint format, the refusal of a JAX orbax directory; and the paths
that serve checkpoints: ``cli serve --torch_checkpoints`` / ``--path``
(``--type``, ``--mid*``) / ``--model dip`` built through ``_build_server``
and driven by ``PoseClient``s against the JAX package's sessions on the
same parameters, ``POST /v1/reload`` onto a newer epoch, and
``convert-checkpoint`` both ways (the JAX CLI's own ``convert-checkpoint
--torch`` reads the port's ``.tar``).

Conversion is exact (0.0: transposes, splits and concatenations only).
Served poses are held at 1e-5: fp32 on both sides at hidden width 8, sums
reordered by the frameworks' matmul kernels; the port against its own
in-process session at 1e-6."""

import contextlib
import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from a3gc_tpu import cli as JCLI
from a3gc_tpu.compat import torch_export as JE
from a3gc_tpu.compat import torch_import as JI
from a3gc_tpu.data import load_adjacency_template
from a3gc_tpu.eval.streaming import DipStreamingSession as JaxDipSession
from a3gc_tpu.eval.streaming import StreamingCascade as JaxCascade
from a3gc_tpu.models import nets as JN
from a3gc_tpu.models import pipeline as JPL
from a3gc_tpu.utils import checkpoint as JCK
from a3gc_tpu_torch import cli as TCLI
from a3gc_tpu_torch.client import PoseClient
from a3gc_tpu_torch.compat import from_jax as FJ
from a3gc_tpu_torch.compat import torch_export as TE
from a3gc_tpu_torch.compat import torch_import as TI
from a3gc_tpu_torch.data import load_stats
from a3gc_tpu_torch.models import nets as TN
from a3gc_tpu_torch.utils import checkpoint as TCK

from torch_port_oracle import cascades, jax_graph_net, perturbed, to_jnp

# tiny tensors: intra-op threads would only contend with the other test
# workers' (and the servers' handler threads)
torch.set_num_threads(1)

H = 8
W = 6
POSE_TOL = 1e-5
FAMILIES = ["a3gc", "aagc", "agc", "ggru", "tp", "dip", "dip_uni"]
DENSE_DIMS = {"tp": (72, 15), "dip": (60, 135), "dip_uni": (60, 135)}


@pytest.fixture(autouse=True)
def _no_data_root_from_earlier_tests(monkeypatch):
    # the JAX CLI's main sets $A3GC_DATA_ROOT and leaves it set: after one
    # of its tests in this process, the port's runs here would read that
    # root's stats and SMPL file and their JAX or subprocess counterparts
    # would not
    monkeypatch.delenv("A3GC_DATA_ROOT", raising=False)


def _shared_adj(cell):
    """An AGC cell whose four gates share one adjacency, as the reference
    stores it (the perturbed oracle draws four)."""
    adj = np.repeat(cell.adj[:, :1], 4, axis=1)
    return cell.replace(adj=adj)


def _net(family, seed):
    """(the port's net config, JAX params with numpy leaves)."""
    if family in DENSE_DIMS:
        ni, no = DENSE_DIMS[family]
        bi = family != "dip_uni"
        jcfg = JN.DIPConfig(n_input=ni, n_output=no, n_hidden=H,
                            bidirectional=bi)
        params = perturbed(JN.init_dip(jax.random.PRNGKey(seed), jcfg), seed)
        return TN.DIPConfig(n_input=ni, n_output=no, n_hidden=H,
                            bidirectional=bi), params
    _, params = jax_graph_net(family, 12, 3, H, seed)
    if family == "agc":
        params = params.replace(rnn1=_shared_adj(params.rnn1),
                                rnn2=_shared_adj(params.rnn2))
    return TN.GraphNetConfig(cell=family, units_in=12, units_out=3,
                             units_hidden=H), params


def _from_jax(family, params):
    if family in DENSE_DIMS:
        return FJ.dip_params_from_jax(params, device="cpu")
    return FJ.graph_net_params_from_jax(params, device="cpu")


def _jax_sd(family, params):
    if family in DENSE_DIMS:
        return JE.dip_state_dict(params)
    return JE.graph_net_state_dict(params, family)


def _port_sd(family, module):
    if family in DENSE_DIMS:
        return TE.dip_state_dict(module)
    return TE.graph_net_state_dict(module, family)


def _import(sd, family, cfg):
    if family in DENSE_DIMS:
        return TI.dip_params_from_state_dict(sd, cfg=cfg, device="cpu")
    return TI.graph_net_params_from_state_dict(sd, family, cfg=cfg,
                                               device="cpu")


def _assert_same(got, want):
    got, want = list(got.named_parameters()), list(want.named_parameters())
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.is_contiguous(), name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_port_importer_equals_from_jax(family):
    cfg, params = _net(family, seed=3)
    _assert_same(_import(_jax_sd(family, params), family, cfg),
                 _from_jax(family, params))


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_port_exporter_equals_jax_exporter(family):
    _, params = _net(family, seed=4)
    want = _jax_sd(family, params)
    got = _port_sd(family, _from_jax(family, params))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_port_tar_is_read_both_ways(family, tmp_path):
    cfg, params = _net(family, seed=5)
    jax_tar, port_tar = str(tmp_path / "jax.tar"), str(tmp_path / "port.tar")
    JE.save_torch_checkpoint(jax_tar, _jax_sd(family, params), epoch=3)
    ours = _import(TI.load_torch_checkpoint(jax_tar), family, cfg)
    _assert_same(ours, _from_jax(family, params))

    TE.save_torch_checkpoint(port_tar, _port_sd(family, ours), epoch=4)
    assert torch.load(port_tar, weights_only=True)["epoch"] == 4
    sd = JI.load_torch_checkpoint(port_tar)
    back = (JI.dip_params_from_state_dict(
        sd, bidirectional=family != "dip_uni") if family in DENSE_DIMS
        else JI.graph_net_params_from_state_dict(sd, family))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_torch_port_importer_refuses_another_width():
    cfg, params = _net("a3gc", seed=6)
    sd = _jax_sd("a3gc", params)
    wide = dataclasses.replace(cfg, units_hidden=2 * H)
    with pytest.raises(ValueError, match=r"'linear_in.gcn_kernel' has shape "
                                         r"\(8, 12\).*expects \(16, 12\)"):
        TI.graph_net_params_from_state_dict(sd, "a3gc", cfg=wide,
                                            device="cpu")
    aagc = dataclasses.replace(cfg, cell="aagc")
    _, aagc_params = _net("aagc", seed=6)
    with pytest.raises(ValueError, match="has no 'rnn1.directions.0.cell."
                                         "attention_w'"):
        TI.graph_net_params_from_state_dict(_jax_sd("aagc", aagc_params),
                                            "a3gc", cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="config of cell 'aagc'"):
        TI.graph_net_params_from_state_dict(sd, "a3gc", cfg=aagc,
                                            device="cpu")
    # a bidirectional DIP checkpoint against a unidirectional config
    uni, _ = _net("dip_uni", seed=6)
    _, bi_params = _net("dip", seed=6)
    with pytest.raises(ValueError, match=r"'rnn.weight_ih_l1' has shape "
                                         r"\(32, 16\).*expects \(32, 8\)"):
        TI.dip_params_from_state_dict(_jax_sd("dip", bi_params), cfg=uni,
                                      device="cpu")


TREES = {
    "both_phases": ["checkpoint_model1_pretrain_3",
                    "checkpoint_model1_pretrain_11",
                    "checkpoint_model1_finetuning_5",
                    "checkpoint_model1_finetuning_20",
                    "checkpoint_model2_finetuning_2",
                    "checkpoint_model2_finetuning_10",
                    "checkpoint_model3_pretrain_4"],
    "one_phase": ["checkpoint_model1_finetuning_4",
                  "checkpoint_model1_finetuning_3",
                  "checkpoint_model2_finetuning_10",
                  "checkpoint_model3_finetuning_3"],
    "missing_stage": ["checkpoint_model1_pretrain_1",
                      "checkpoint_model3_finetuning_4"],
    "non_matching": ["checkpoint_model1_pretrain_3.tar",
                     "checkpoint_model1_pretrain_x",
                     "model1_pretrain_10",
                     "checkpoint_model12_pretrain_5",
                     "checkpoint_model1_training_6",
                     "checkpoint_model1_pretrain_4"],
    "empty": [],
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_torch_port_discover_latest_matches_jax(tree, tmp_path):
    for name in TREES[tree]:
        (tmp_path / name).mkdir()
    answers = set()
    for stage in (1, 2, 3, 12):
        for phase in (None, "pretrain", "finetuning"):
            for epoch in (None, 3, 4, 10):
                args = (str(tmp_path), stage, phase, epoch)
                got = TCK.discover_latest(*args)
                assert got == JCK.discover_latest(*args), args
                answers.add(got)
    assert len(answers) > 1 or tree == "empty"


def _port_template(family, seed=1):
    cfg, _ = _net(family, seed)
    gen = torch.Generator().manual_seed(seed)
    if family in DENSE_DIMS:
        return TN.init_dip(gen, cfg)
    return TN.init_graph_net(gen, cfg, load_adjacency_template())


@pytest.mark.parametrize("family", ["a3gc", "ggru", "tp", "dip_uni"])
def test_torch_port_save_restore_round_trip(family, tmp_path):
    _, params = _net(family, seed=7)
    ours = _from_jax(family, params)
    path = TCK.save_params(ours, str(tmp_path), stage=2, epoch=7,
                           finetuning=True)
    assert os.path.basename(path) == "checkpoint_model2_finetuning_7"
    assert TCK.discover_latest(str(tmp_path), 2) == (path, 7)
    assert torch.load(os.path.join(path, TCK.PARAMS_FILE),
                      weights_only=True)["epoch"] == 7
    _assert_same(TCK.restore_params(path, _port_template(family)), ours)
    cfg = _net(family, seed=1)[0]
    wider = (dataclasses.replace(cfg, n_hidden=2 * H) if family in DENSE_DIMS
             else dataclasses.replace(cfg, units_hidden=2 * H))
    gen = torch.Generator().manual_seed(0)
    template = (TN.init_dip(gen, wider) if family in DENSE_DIMS else
                TN.init_graph_net(gen, wider, load_adjacency_template()))
    with pytest.raises(ValueError, match="has shape"):
        TCK.restore_params(path, template)
    with pytest.raises(FileNotFoundError):
        TCK.restore_params(str(tmp_path / "absent"), template)


def test_torch_port_restore_refuses_orbax_and_the_test_reader(tmp_path):
    """A JAX orbax checkpoint cannot be read without JAX: the port names
    the conversion. The test side reads it with JAX (orbax → numpy →
    ``from_jax``) and gets the original parameters."""
    jcfg, params = jax_graph_net("a3gc", 12, 3, H, 8)
    path = JCK.save_params(to_jnp(params), str(tmp_path), stage=1, epoch=2)
    with pytest.raises(ValueError, match="convert-checkpoint --to_torch"):
        TCK.restore_params(path, _port_template("a3gc"))
    assert TCK.discover_latest(str(tmp_path), 1) == (path, 2)
    template = JN.init_graph_net(jax.random.PRNGKey(0), jcfg,
                                 load_adjacency_template())
    back = JCK.restore_params(path, template)
    _assert_same(FJ.graph_net_params_from_jax(
        jax.tree_util.tree_map(np.array, back), device="cpu"),
        FJ.graph_net_params_from_jax(params, device="cpu"))


# ---------------------------------------------------------------------------
# the served paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    from __graft_entry__ import _body_model
    return _body_model(n_vertices=48)


@contextlib.contextmanager
def _cli_server(argv):
    args = TCLI.build_parser().parse_args(
        ["serve", "--device", "cpu", "--port", "0", "--streams", "2",
         "--window", str(W), "--max_wait_ms", "2", "--hu1", str(H),
         "--hu2", str(H), "--hu3", str(H)] + argv)
    TCLI._apply_quality(args)
    srv, streams, window = TCLI._build_server(args)
    assert (streams, window) == (2, W)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    clients = [PoseClient(*srv.address[:2], timeout=30.0, retry_s=5.0,
                          retry_interval=0.05) for _ in range(2)]
    try:
        for c in clients:
            c.acquire()
        yield clients
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


def _feeds(n, seed):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=(W, 54)).astype(np.float32),
              rng.normal(scale=0.5, size=(W, 18)).astype(np.float32))
             for _ in range(n)] for _ in range(2)]


def _drive(clients, refs, feeds, windows):
    """Each client against its single-slot JAX session on the same
    windows."""
    for w in windows:
        for c, ref, feed in zip(clients, refs, feeds):
            got, want = c.step(*feed[w]), np.asarray(ref.step(*feed[w]))
            assert got.shape == (W, 24, 3, 3)
            np.testing.assert_allclose(got, want, atol=POSE_TOL,
                                       err_msg=f"window {w}")


def _jax_cascades(jcfg, params3, jax_model):
    return [JaxCascade(to_jnp(params3), jcfg, jax_model, window=W,
                       stats=load_stats(), normalize=True) for _ in range(2)]


def _write_tars(tmp_path, params3, cell):
    paths = []
    for i, p in enumerate(params3):
        paths.append(str(tmp_path / f"s{i + 1}.tar"))
        JE.save_torch_checkpoint(paths[-1], JE.graph_net_state_dict(p, cell))
    return paths


def test_torch_port_cli_serves_torch_checkpoints_like_jax(tmp_path,
                                                          jax_model):
    """``serve --torch_checkpoints`` with three ``.tar``s written by the
    JAX exporter from JAX params serves what JAX's StreamingCascade computes
    on those params."""
    jcfg, _, params3 = cascades("a3gc", hidden=H, seed=30)
    tars = _write_tars(tmp_path, params3, "a3gc")
    feeds = _feeds(3, seed=31)
    refs = _jax_cascades(jcfg, params3, jax_model)
    with _cli_server(["--norm", "--torch_checkpoints"] + tars) as clients:
        _drive(clients, refs, feeds, range(3))
    with pytest.raises(SystemExit, match="one .tar per stage"):
        with _cli_server(["--torch_checkpoints"] + tars[:2]):
            pass
    with pytest.raises(SystemExit, match=r"s1.tar: .*'linear_in.gcn_kernel' "
                                         r"has shape \(8, 12\)"):
        with _cli_server(["--torch_checkpoints"] + tars + ["--hu1", "16"]):
            pass


def _save_stage(directory, params, stage, epoch, phase="finetuning"):
    TCK.save_params(FJ.graph_net_params_from_jax(params, device="cpu"),
                    str(directory), stage, epoch,
                    finetuning=phase == "finetuning")


def test_torch_port_cli_serves_path_with_type_and_pins(tmp_path, jax_model):
    """``serve --path`` discovers one checkpoint a stage of the asked
    ``--type`` (default finetuning), ``--mid*`` pinning an epoch; a stage
    with no checkpoint exits naming it."""
    jcfg, _, old = cascades("a3gc", hidden=H, seed=40)
    _, _, new = cascades("a3gc", hidden=H, seed=50)
    for i in range(3):
        _save_stage(tmp_path, old[i], i + 1, 2)
        _save_stage(tmp_path, new[i], i + 1, 5)
    _save_stage(tmp_path, new[0], 1, 9, phase="pretrain")
    served = (old[0], new[1], old[2])          # --mid1 2, --mid3 2
    feeds = _feeds(2, seed=41)
    refs = _jax_cascades(jcfg, served, jax_model)
    with _cli_server(["--norm", "--path", str(tmp_path), "--mid1", "2",
                      "--mid3", "2"]) as clients:
        _drive(clients, refs, feeds, range(2))
    with pytest.raises(SystemExit, match="no pretrain checkpoint for stage "
                                         "2"):
        with _cli_server(["--path", str(tmp_path), "--type", "pretrain"]):
            pass
    with pytest.raises(SystemExit, match="stage 3 .* at epoch 7"):
        with _cli_server(["--path", str(tmp_path), "--mid3", "7"]):
            pass


def test_torch_port_cli_reload_serves_the_newer_epoch(tmp_path, jax_model):
    """``POST /v1/reload`` re-discovers ``--path``: training wrote a newer
    epoch, and the next windows are those of the newer params from the
    carried state."""
    jcfg, _, old = cascades("a3gc", hidden=H, seed=60)
    _, _, new = cascades("a3gc", hidden=H, seed=70)
    for i in range(3):
        _save_stage(tmp_path, old[i], i + 1, 1)
    feeds = _feeds(4, seed=61)
    refs = _jax_cascades(jcfg, old, jax_model)
    with _cli_server(["--norm", "--path", str(tmp_path)]) as clients:
        _drive(clients, refs, feeds, range(2))
        for i in range(3):
            _save_stage(tmp_path, new[i], i + 1, 3)
        assert clients[0].reload() == {"reloaded": True}
        for ref in refs:
            ref.params3 = to_jnp(new)
        _drive(clients, refs, feeds, range(2, 4))


def _jax_dip(seed):
    jcfg = JN.DIPConfig(n_hidden=H)
    params = perturbed(JN.init_dip(jax.random.PRNGKey(seed), jcfg), seed)
    return JPL.PoseNetConfig(net=jcfg, rotsize=9), params


def test_torch_port_cli_serves_dip_and_reloads(tmp_path, jax_model):
    """``serve --model dip`` from a ``.tar``, and from ``--path`` with a
    reload onto a newer epoch, against JAX's DipStreamingSession; with
    neither source it exits."""
    jcfg, old = _jax_dip(80)
    _, new = _jax_dip(81)
    tar = str(tmp_path / "dip.tar")
    JE.save_torch_checkpoint(tar, JE.dip_state_dict(old))
    feeds = _feeds(4, seed=82)

    def refs(params):
        return [JaxDipSession(to_jnp(params), jcfg, jax_model, window=W,
                              stats=load_stats()) for _ in range(2)]

    with _cli_server(["--model", "dip", "--torch_checkpoints",
                      tar]) as clients:
        _drive(clients, refs(old), feeds, range(2))
    ckpts = tmp_path / "runs"
    TCK.save_params(FJ.dip_params_from_jax(old, device="cpu"), str(ckpts),
                    1, 4, finetuning=True)
    with _cli_server(["--model", "dip", "--path", str(ckpts)]) as clients:
        sessions = refs(old)
        _drive(clients, sessions, feeds, range(2))
        TCK.save_params(FJ.dip_params_from_jax(new, device="cpu"),
                        str(ckpts), 1, 6, finetuning=True)
        assert clients[1].reload() == {"reloaded": True}
        for s in sessions:
            s.params3 = to_jnp(new)
        _drive(clients, sessions, feeds, range(2, 4))
    with pytest.raises(SystemExit, match="--torch_checkpoints DIP.tar or "
                                         "--path DIR"):
        with _cli_server(["--model", "dip"]):
            pass


def test_torch_port_cli_reload_of_a_missing_checkpoint_is_an_error(
        tmp_path):
    """A reload that finds no checkpoint answers 500 and the server goes
    on serving the params it has."""
    _, _, params3 = cascades("a3gc", hidden=H, seed=90)
    ckpts = tmp_path / "runs"
    for i in range(3):
        _save_stage(ckpts, params3[i], i + 1, 1)
    feeds = _feeds(2, seed=91)
    with _cli_server(["--path", str(ckpts)]) as clients:
        before = clients[0].step(*feeds[0][0])
        for name in os.listdir(ckpts):
            os.rename(ckpts / name, tmp_path / name)
        with pytest.raises(Exception, match="no finetuning checkpoint for "
                                            "stage 1"):
            clients[0].reload()
        assert clients[0].stats()["errors"] == 0
        assert np.isfinite(clients[0].step(*feeds[0][1])).all()
    assert before.shape == (W, 24, 3, 3)


def test_torch_port_cli_convert_checkpoint_both_ways(tmp_path, capsys):
    """``convert-checkpoint --torch`` writes a port checkpoint equal to the
    ``.tar``'s params; ``--to_torch`` writes the ``.tar`` back, key for key
    and bit for bit; JAX's own ``convert-checkpoint --torch`` reads the
    port's ``.tar``."""
    _, params = _net("a3gc", seed=12)
    src = str(tmp_path / "src.tar")
    JE.save_torch_checkpoint(src, JE.graph_net_state_dict(params, "a3gc"))
    ckpt = str(tmp_path / "runs" / "checkpoint_model1_finetuning_3")
    TCLI.main(["convert-checkpoint", "--torch", src, "--model", "a3gc",
               "--output", ckpt, "--epoch", "3"])
    assert "converted" in capsys.readouterr().out
    assert TCK.discover_latest(str(tmp_path / "runs"), 1) == (ckpt, 3)
    _assert_same(TCK.restore_params(ckpt, _port_template("a3gc")),
                 FJ.graph_net_params_from_jax(params, device="cpu"))

    out = str(tmp_path / "back.tar")
    TCLI.main(["convert-checkpoint", "--to_torch", ckpt, "--model", "a3gc",
               "--n_input", "12", "--n_output", "3", "--hu1", str(H),
               "--output", out, "--epoch", "5"])
    got, want = TI.load_torch_checkpoint(out), TI.load_torch_checkpoint(src)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert torch.load(out, weights_only=True)["epoch"] == 5

    orbax = str(tmp_path / "orbax")
    JCLI.main(["convert-checkpoint", "--torch", out, "--model", "a3gc",
               "--output", orbax])
    template = JN.init_graph_net(
        jax.random.PRNGKey(0), JN.GraphNetConfig(
            cell="a3gc", units_in=12, units_out=3, units_hidden=H),
        load_adjacency_template())
    for a, b in zip(jax.tree_util.tree_leaves(
            JCK.restore_params(orbax, template)),
            jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port refuses the orbax directory, naming the way back
    with pytest.raises(SystemExit, match="convert-checkpoint --to_torch"):
        TCLI.main(["convert-checkpoint", "--to_torch", orbax, "--model",
                   "a3gc", "--n_input", "12", "--n_output", "3", "--hu1",
                   str(H), "--output", str(tmp_path / "x.tar")])
    with pytest.raises(SystemExit, match="give --torch"):
        TCLI.main(["convert-checkpoint", "--model", "dip", "--output", "x"])
