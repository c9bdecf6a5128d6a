"""The port's training feed (``a3gc_tpu_torch/data``) against the JAX
package's: ``synthetic_packed_dataset`` and the ``Sampler`` streams
bit-equal, device gathers bit-equal, ``graph_batch`` / ``flat_batch``
without noise within 1e-6, the stats within fp32 rounding of the same
float64 sums, and ``cli stats`` against the JAX CLI's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3gc_tpu.data import pipeline as JDP
from a3gc_tpu.data import stats as JST
from a3gc_tpu.data.synthetic import synthetic_packed_dataset as jax_synth
from a3gc_tpu_torch.data import pipeline as TDP
from a3gc_tpu_torch.data import stats as TST
from a3gc_tpu_torch.data.synthetic import synthetic_packed_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def packed():
    return synthetic_packed_dataset(n_seqs=10, seq_len=12, seed=3)


@pytest.mark.parametrize("n, t, seed", [(8, 16, 0), (10, 12, 3), (3, 30, 7)])
def test_torch_port_synthetic_dataset_is_bit_equal(n, t, seed):
    ours, ref = synthetic_packed_dataset(n, t, seed), jax_synth(n, t, seed)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=0),
    dict(shuffle=True, seed=(0, 10003)),
    dict(shuffle=False, pad_remainder=True),
    dict(shuffle=True, seed=5, pad_remainder=True),
    dict(shuffle=True, seed=5, drop_remainder=False),
])
def test_torch_port_sampler_streams_are_bit_equal(packed, kw):
    ours = TDP.Sampler(packed, 4, **kw)
    ref = JDP.Sampler(packed, 4, **kw)
    assert len(ours) == len(ref)
    for (t1, w1), (t2, w2) in zip(ours.iter_indices(), ref.iter_indices(),
                                  strict=True):
        np.testing.assert_array_equal(t1, t2)
        assert (w1 is None) == (w2 is None)
        if w1 is not None:
            np.testing.assert_array_equal(w1, w2)
    for b1, b2 in zip(TDP.Sampler(packed, 4, **kw),
                      JDP.Sampler(packed, 4, **kw), strict=True):
        assert b1.keys() == b2.keys()
        for k in b2:
            np.testing.assert_array_equal(b1[k], b2[k])


def test_torch_port_sampler_refuses_what_jax_refuses(packed):
    with pytest.raises(ValueError, match="exceeds"):
        TDP.Sampler(packed, 16)
    assert len(TDP.Sampler(packed, 16, pad_remainder=True)) == 1
    with pytest.raises(ValueError, match="same packed dict"):
        TDP.Sampler(packed, 4, device_data={"acc": torch.zeros(3)})


def test_torch_port_device_gather_is_bit_equal(packed):
    """``put_device`` + ``gather`` (index_select on the corpus' device)
    against the JAX package's upload and in-step gather, padded tail
    weights included."""
    from a3gc_tpu.train.loop import _gather_batch
    dd = TDP.put_device(packed, "cpu")
    assert TDP.put_device(dd, "cpu")["acc"] is dd["acc"]   # pass-through
    jdd = JDP.put_device(packed)
    sampler = TDP.Sampler(packed, 4, seed=2, pad_remainder=True,
                          device_data=dd)
    for take, w in sampler.iter_indices():
        ours = TDP.gather(dd, torch.as_tensor(take), torch.as_tensor(w))
        ref = _gather_batch(jdd, jnp.asarray(take), jnp.asarray(w))
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def _stats():
    from a3gc_tpu_torch.data import load_stats
    return load_stats()


@pytest.mark.parametrize("rotsize", [9, 6])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("graph", [True, False])
def test_torch_port_batches_match_jax(packed, graph, norm, rotsize):
    raw = {k: v[:3] for k, v in packed.items()}
    stats = _stats() if norm else None
    if graph:
        ours = TDP.graph_batch({k: torch.as_tensor(v) for k, v in
                                raw.items()},
                               None if stats is None else
                               {k: torch.as_tensor(v)
                                for k, v in stats.items()},
                               rotsize=rotsize)
        ref = JDP.graph_batch(raw, stats, rotsize=rotsize)
    else:
        ours = TDP.flat_batch({k: torch.as_tensor(v) for k, v in
                               raw.items()},
                              None if stats is None else
                              {k: torch.as_tensor(v)
                               for k, v in stats.items()},
                              rotsize=rotsize)
        ref = JDP.flat_batch(raw, stats, rotsize=rotsize)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("graph", [True, False])
def test_torch_port_teacher_forcing_noise(packed, graph):
    """With a generator: the noisy inputs are the clean ones plus std·N(0,
    1) (the JAX package's distribution, other bits), the targets clean,
    the same generator seed the same draw."""
    raw = {k: torch.as_tensor(v) for k, v in packed.items()}
    std = 0.5
    if graph:
        def run(gen):
            return TDP.graph_batch(raw, rng=gen, noise_std=std)
    else:
        def run(gen):
            return TDP.flat_batch(raw, rng=gen, leaf_noise_std=std,
                                  full_noise_std=std)
    clean = run(None)
    a = run(torch.Generator().manual_seed(4))
    b = run(torch.Generator().manual_seed(4))
    for i in (0, 3, 4, 5):
        np.testing.assert_array_equal(a[i].numpy(), clean[i].numpy())
    for i in (1, 2):
        np.testing.assert_array_equal(a[i].numpy(), b[i].numpy())
        noise = (a[i] - (clean[i])).numpy()
        real = noise[np.abs(noise) > 0] if graph and i == 1 else noise
        assert abs(real.std() - std) < 0.05 * std
        assert abs(real.mean()) < 0.05


def test_torch_port_stats_match_jax(packed, tmp_path):
    fields = {k: [v.reshape(-1, *v.shape[2:])[:50],
                  v.reshape(-1, *v.shape[2:])[50:]]
              for k, v in packed.items()}
    ours, ref = TST.compute_stats(fields), JST.compute_stats(fields)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    path = TST.save_stats(ours, str(tmp_path / "s" / "stats.npz"))
    back = JST.load_stats(path)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    back = TST.load_stats(JST.save_stats(ref, str(tmp_path / "j.npz")))
    for k in ref:
        np.testing.assert_array_equal(back[k], ours[k])


def test_torch_port_convert_torch_stats(tmp_path):
    entry = {"mean_channel": np.arange(3.0), "std_channel": np.ones(3),
             "mean_all": 1.5, "std_all": 0.5}
    pt = str(tmp_path / "stats.pt")
    torch.save({"acc": entry}, pt)
    ours = TST.load_stats(TST.convert_torch_stats(pt, str(tmp_path / "a.npz")))
    ref = JST.load_stats(JST.convert_torch_stats(pt, str(tmp_path / "b.npz")))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_torch_port_cli_stats_matches_jax_cli(packed, tmp_path):
    from a3gc_tpu import cli as JCLI
    from a3gc_tpu_torch import cli as TCLI
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(a, **packed)
    np.savez(b, **synthetic_packed_dataset(4, 12, seed=9))
    TCLI.main(["stats", "--inputs", a, b, "--output",
               str(tmp_path / "ours.npz")])
    JCLI.main(["stats", "--inputs", a, b, "--output",
               str(tmp_path / "ref.npz")])
    ours = TST.load_stats(str(tmp_path / "ours.npz"))
    ref = JST.load_stats(str(tmp_path / "ref.npz"))
    assert ours.keys() == ref.keys() and len(ref) == 20
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_torch_port_load_packed(packed, tmp_path):
    path = str(tmp_path / "p.npz")
    np.savez(path, **packed)
    ours, ref = TDP.load_packed(path), JDP.load_packed(path)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
