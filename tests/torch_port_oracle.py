"""Shared oracle helpers for the tests of the PyTorch port (a3gc_tpu_torch):
JAX parameters made with jax.random and then perturbed with numpy, so every
parameter (biases, attention biases, adjacency) is nonzero and both packages
get the same arrays."""

import jax
import jax.numpy as jnp
import numpy as np

from a3gc_tpu.data import load_adjacency_template
from a3gc_tpu.models import cells as JC
from a3gc_tpu.models import layers as JL
from a3gc_tpu.models import nets as JN


def perturbed(tree, seed, scale=0.1):
    """numpy copy of a JAX pytree with N(0, scale²) noise on every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + scale * rng.normal(size=np.shape(a))).astype(np.float32),
        tree)


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_cell_params2(cell, units_in, hidden, seed):
    """Direction-stacked JAX cell params (numpy leaves, perturbed)."""
    nira = load_adjacency_template()

    def one(k):
        return JC.init_gcn_lstm_cell(
            jax.random.PRNGKey(k), units_in, hidden, nira,
            attention=cell in ("a3gc", "agc"),
            shared_fixed_adj=cell == "agc")

    return perturbed(JL.stack_directions(one(seed), one(seed + 1)), seed)


def jax_graph_net(cell, units_in, units_out, hidden, seed):
    """(JAX GraphNetConfig on the XLA scan, perturbed numpy params)."""
    cfg = JN.GraphNetConfig(cell=cell, units_in=units_in,
                            units_out=units_out, units_hidden=hidden,
                            backend="xla")
    params = JN.init_graph_net(jax.random.PRNGKey(seed), cfg,
                               load_adjacency_template())
    return cfg, perturbed(params, seed)


GRAPH_DIMS = ((12, 3, 3), (15, 3, 3), (15, 9, 9))      # units in, out, rotsize
TP_DIMS = ((72, 15, 3), (87, 69, 3), (141, 135, 9))    # n_input, n_output, rot


def jax_dip(n_input, n_output, hidden, seed, bidirectional=True):
    """(JAX DIPConfig on the XLA scan, perturbed numpy params)."""
    cfg = JN.DIPConfig(n_input=n_input, n_output=n_output, n_hidden=hidden,
                       bidirectional=bidirectional)
    return cfg, perturbed(JN.init_dip(jax.random.PRNGKey(seed), cfg), seed)


def cascades(kind, hidden=8, seed=20):
    """The same small cascade in both packages: (JAX CascadeConfig on the
    XLA scans, the port's CascadeConfig, perturbed numpy params of the three
    stages). ``kind``: a graph cell name, or "tp" for the dense cascade."""
    from a3gc_tpu.models import pipeline as JPL
    from a3gc_tpu_torch.models import nets as TN
    from a3gc_tpu_torch.models import pipeline as TPL

    if kind == "tp":
        jnets = [JN.DIPConfig(n_input=ni, n_output=no, n_hidden=hidden)
                 for ni, no, _ in TP_DIMS]
        tnets = [TN.DIPConfig(n_input=ni, n_output=no, n_hidden=hidden)
                 for ni, no, _ in TP_DIMS]
        rots = [rot for _, _, rot in TP_DIMS]
    else:
        jnets = [JN.GraphNetConfig(cell=kind, units_in=ui, units_out=uo,
                                   units_hidden=hidden, backend="xla")
                 for ui, uo, _ in GRAPH_DIMS]
        tnets = [TN.GraphNetConfig(cell=kind, units_in=ui, units_out=uo,
                                   units_hidden=hidden)
                 for ui, uo, _ in GRAPH_DIMS]
        rots = [rot for _, _, rot in GRAPH_DIMS]
    jcfg = JPL.CascadeConfig(*(JPL.PoseNetConfig(net=n, rotsize=r)
                               for n, r in zip(jnets, rots)))
    tcfg = TPL.CascadeConfig(*(TPL.PoseNetConfig(net=n, rotsize=r)
                               for n, r in zip(tnets, rots)))
    nira = load_adjacency_template()
    params = tuple(
        perturbed(JPL.init_pose_net(jax.random.PRNGKey(i), c, nira),
                  seed=seed + i)
        for i, c in enumerate((jcfg.stage1, jcfg.stage2, jcfg.stage3)))
    return jcfg, tcfg, params


def state_leaves(tree):
    """The leaves of a carried state (JAX arrays or torch tensors) as numpy
    arrays, in order."""
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in state_leaves(t)]
    return [tree.numpy() if hasattr(tree, "numpy") else np.asarray(tree)]


def random_rotations(rng, shape):
    """Uniform random rotation matrices [*shape, 9] (normalized Gaussian
    quaternions), fp32."""
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).astype(np.float32)


def eval_sequences(lengths, seed=0):
    """Synthetic test sequences in the schema ``load_test_sequences`` reads:
    ori [T, 54] and pose [T, 135] rotation matrices, acc [T, 18]."""
    rng = np.random.default_rng(seed)
    return [{"ori": random_rotations(rng, (T, 6)).reshape(T, 54),
             "acc": rng.normal(scale=0.5, size=(T, 18)).astype(np.float32),
             "pose": random_rotations(rng, (T, 15)).reshape(T, 135)}
            for T in lengths]
