"""MSCN / TreeLSTM training. Port of `nngp_tpu/baselines/mscn_trainer.py`
(`plans_to_arrays` is a numpy-only copy).

MSE loss on log2 cards, AdamW (decoupled weight decay, as `optax.adamw`),
a minibatch loop in the order of `np.random.default_rng(seed)`, the JAX
trainers' stream. Plan chains are padded to the max chain length and the
batched chain model trains like any other batch.

Set batches are zero-padded; MSCN pooling includes the padding rows, as the
original MSCN pools over the padded axis. The TreeLSTM trainer passes masks
(its min-pool would otherwise be poisoned by all-padding sets).

Every trainer takes `device` ("cuda" unless the caller asks for the CPU; no
fallback) and `init`, a state_dict that replaces the seeded initial
parameters, and returns the trained model on that device.
"""

from typing import Sequence, Tuple

import numpy as np
import torch

from nngp_tpu_torch.baselines.trainer import _epoch_perm, _place
from nngp_tpu_torch.models.mscn import MSCN, MSCNJoin, MSCNMultiJoin
from nngp_tpu_torch.models.tree_lstm import TreeLSTMMultiJoin
from nngp_tpu_torch.utils.device import resolve_device


def to_device(arrays, device):
    """Float arrays as fp32 tensors, boolean ones as they are, on device."""
    return tuple(torch.as_tensor(a, device=device) if a.dtype == bool else
                 torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def _train_loop(model, inputs, y, epochs, batch_size, lr, weight_decay,
                seed=0, verbose=None):
    """Generic MSE loop over a tuple of device tensors; the epoch's loss is
    read back once per epoch, when verbose."""
    n = y.shape[0]
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    rng = np.random.default_rng(seed)
    model.train()
    for epoch in range(epochs):
        batch_idx = torch.as_tensor(_epoch_perm(n, batch_size, rng),
                                    device=y.device)
        total = torch.zeros((), dtype=y.dtype, device=y.device)
        for idx in batch_idx:
            out = model(*(a[idx] for a in inputs))
            loss = torch.mean((out - y[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach()
        if verbose:
            verbose(f"{epoch}-th Epochs: Train MSE Loss={float(total):.4f}")
    model.eval()
    return model


def _train(make_model, arrays, y, epochs, batch_size, lr, weight_decay, seed,
           verbose, device, init):
    device = resolve_device(device)
    inputs = to_device(arrays, device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    model = _place(make_model(torch.Generator().manual_seed(seed)), init,
                   device)
    return _train_loop(model, inputs, y, epochs, batch_size, lr,
                       weight_decay, seed, verbose)


def train_mscn_single(pred_x, y, epochs=40, batch_size=128, lr=1e-3,
                      weight_decay=8e-5, seed=0, verbose=None, device="cuda",
                      init=None, **model_kw):
    return _train(
        lambda g: MSCN(pred_x.shape[-1], generator=g, **model_kw),
        (pred_x,), y, epochs, batch_size, lr, weight_decay, seed, verbose,
        device, init)


def train_mscn_join(left_x, right_x, join_x, y, epochs=40, batch_size=128,
                    lr=1e-3, weight_decay=8e-5, seed=0, verbose=None,
                    device="cuda", init=None, **model_kw):
    return _train(
        lambda g: MSCNJoin(left_x.shape[-1], join_x.shape[-1], generator=g,
                           **model_kw),
        (left_x, right_x, join_x), y, epochs, batch_size, lr, weight_decay,
        seed, verbose, device, init)


def train_mscn_multi(table_x, pred_x, join_x, y, epochs=40, batch_size=128,
                     lr=1e-3, weight_decay=8e-5, seed=0, verbose=None,
                     device="cuda", init=None, **model_kw):
    return _train(
        lambda g: MSCNMultiJoin(table_x.shape[-1], pred_x.shape[-1],
                                join_x.shape[-1], generator=g, **model_kw),
        (table_x, pred_x, join_x), y, epochs, batch_size, lr, weight_decay,
        seed, verbose, device, init)


# ---------------------------------------------------------------- TreeLSTM
def plans_to_arrays(roots: Sequence) -> Tuple:
    """Flatten PlanNode chains into padded batch arrays for
    TreeLSTMMultiJoin: (leaf_pred, leaf_op, leaf_meta, node_pred, node_op,
    node_meta, node_valid, leaf_pred_mask, node_pred_mask)."""
    all_leaves, all_nodes = [], []
    for root in roots:
        nodes, leaves = [], []
        node = root
        while node.level > 0:
            nodes.append(node)
            leaves.append(node.children[0])
            node = node.children[1]
        leaves.append(node)
        all_leaves.append(leaves[::-1])
        all_nodes.append(nodes[::-1])

    b = len(roots)
    max_leaves = max(len(l) for l in all_leaves)
    max_nodes = max((len(n) for n in all_nodes), default=0)
    max_nodes = max(max_nodes, 1)

    def feat_dims():
        l0 = all_leaves[0][0]
        return (l0.pred_features.shape[1], l0.op_features.shape[0],
                l0.meta_features.shape[0])

    pf, opf, mf = feat_dims()
    max_leaf_preds = max(l.pred_features.shape[0]
                         for ls in all_leaves for l in ls)
    max_node_preds = max((n.pred_features.shape[0]
                          for ns in all_nodes for n in ns), default=1)

    leaf_pred = np.zeros((b, max_leaves, max_leaf_preds, pf))
    leaf_pred_mask = np.zeros((b, max_leaves, max_leaf_preds), bool)
    leaf_op = np.zeros((b, max_leaves, opf))
    leaf_meta = np.zeros((b, max_leaves, mf))
    node_pred = np.zeros((b, max_nodes, max_node_preds, pf))
    node_pred_mask = np.zeros((b, max_nodes, max_node_preds), bool)
    node_op = np.zeros((b, max_nodes, opf))
    node_meta = np.zeros((b, max_nodes, mf))
    node_valid = np.zeros((b, max_nodes), bool)

    for i, (leaves, nodes) in enumerate(zip(all_leaves, all_nodes)):
        for j, l in enumerate(leaves):
            r = l.pred_features.shape[0]
            leaf_pred[i, j, :r] = l.pred_features
            leaf_pred_mask[i, j, :r] = True
            leaf_op[i, j] = l.op_features
            leaf_meta[i, j] = l.meta_features
        for j, nd in enumerate(nodes):
            r = nd.pred_features.shape[0]
            node_pred[i, j, :r] = nd.pred_features
            node_pred_mask[i, j, :r] = True
            node_op[i, j] = nd.op_features
            node_meta[i, j] = nd.meta_features
            node_valid[i, j] = True
    return (leaf_pred, leaf_op, leaf_meta, node_pred, node_op, node_meta,
            node_valid, leaf_pred_mask, node_pred_mask)


def train_tree_lstm(roots: Sequence, y, epochs=40, batch_size=64, lr=1e-3,
                    weight_decay=8e-5, seed=0, verbose=None, device="cuda",
                    init=None, **model_kw):
    """Returns (model, arrays): the trained model and the padded numpy
    arrays of `roots`."""
    arrays = plans_to_arrays(roots)
    leaf_pred, leaf_op, leaf_meta = arrays[:3]
    model = _train(
        lambda g: TreeLSTMMultiJoin(leaf_pred.shape[-1], leaf_op.shape[-1],
                                    leaf_meta.shape[-1], generator=g,
                                    **model_kw),
        arrays, y, epochs, batch_size, lr, weight_decay, seed, verbose,
        device, init)
    return model, arrays
