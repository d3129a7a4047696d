"""TreeLSTM plan-tree models. Port of `nngp_tpu/models/tree_lstm.py`.

  TreeLSTMJoin      binary-join variant: min-pooled pred set convs averaged,
                    join set conv, single LSTM step, MLP
  TreeLSTMMultiJoin plan-chain variant: per node op/meta linear+relu,
                    min-pool pred set conv, children hidden states averaged
                    and concatenated into the LSTM input, zero pad at
                    leaves; MLP head on the root hidden state.

The LSTM is applied to a length-1 sequence with zero initial state, i.e. a
single cell step, and the recursion threads children states through the
input concat, not the carry. From h0 = c0 = 0 the step is

    c = sigmoid(x W_i + b_i) * tanh(x W_g + b_g),  h = sigmoid(x W_o + b_o) * tanh(c)

so `LSTMStep` holds exactly those parameters: the input kernels of the
i, g, o gates and one bias each. The recurrent kernels and the forget gate
multiply zeros and are left out. (`torch.nn.LSTMCell` has two biases where
the flax cell has one; under Adam both would move and their sum would take a
double step, so training would not be comparable with the JAX package's.)
"""

import torch
from torch import nn

from nngp_tpu_torch.models.baselines import dense
from nngp_tpu_torch.models.mscn import MLPHead, SetConvolution


class LSTMStep(nn.Module):
    """One LSTM step from zero state; gates packed (i, g, o) in one layer."""

    def __init__(self, in_ch: int, hidden: int, generator=None):
        super().__init__()
        self.hidden = hidden
        self.gates = dense(in_ch, 3 * hidden, generator)

    def forward(self, x):
        i, g, o = torch.split(self.gates(x), self.hidden, dim=-1)
        c = torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c)


class TreeLSTMJoin(nn.Module):
    """Binary-join TreeLSTM."""

    def __init__(self, pred_feat: int, join_feat: int, pred_hid_ch: int = 64,
                 pred_out_ch: int = 64, join_hid_ch: int = 64,
                 join_out_ch: int = 64, mlp_hid_ch: int = 64, generator=None):
        super().__init__()
        self.pred_conv = SetConvolution(pred_feat, pred_hid_ch, pred_out_ch,
                                        pool_type="min", generator=generator)
        self.join_conv = SetConvolution(join_feat, join_hid_ch, join_out_ch,
                                        generator=generator)
        self.cell = LSTMStep(pred_out_ch + join_out_ch, mlp_hid_ch, generator)
        self.head = MLPHead(mlp_hid_ch, mlp_hid_ch, generator)

    def forward(self, left_pred_x, right_pred_x, join_x, left_mask=None,
                right_mask=None, join_mask=None):
        left = self.pred_conv(left_pred_x, left_mask)
        right = self.pred_conv(right_pred_x, right_mask)
        pred = (left + right) / 2.0
        join = self.join_conv(join_x, join_mask)
        return self.head(self.cell(torch.cat([pred, join], dim=1)))


class TreeLSTMMultiJoin(nn.Module):
    """Plan-chain TreeLSTM, evaluated as a loop over chain levels.

    Inputs (batch-padded chains of length L+1 leaves / L internal levels):
      leaf_pred_x   (B, L+1, P, F)  per-leaf predicate sets (padded)
      leaf_op_x     (B, L+1, OP)    leaf (table-scan) operator one-hots
      leaf_meta_x   (B, L+1, M)
      node_pred_x   (B, L, P2, F)   per-internal-node stacked pred sets
      node_op_x     (B, L, OP)
      node_meta_x   (B, L, M)
      node_valid    (B, L) bool     False for padding levels (short chains)
    """

    def __init__(self, pred_feat: int, op_feat: int, meta_feat: int,
                 op_out_ch: int = 32, meta_out_ch: int = 32,
                 pred_hid_ch: int = 64, pred_out_ch: int = 64,
                 lstm_hid_ch: int = 64, mlp_hid_ch: int = 64, generator=None):
        super().__init__()
        self.lstm_hid_ch = lstm_hid_ch
        self.op_nn = dense(op_feat, op_out_ch, generator)
        self.meta_nn = dense(meta_feat, meta_out_ch, generator)
        self.pred_conv = SetConvolution(pred_feat, pred_hid_ch, pred_out_ch,
                                        pool_type="min", generator=generator)
        self.cell = LSTMStep(
            lstm_hid_ch + op_out_ch + meta_out_ch + pred_out_ch, lstm_hid_ch,
            generator)
        self.head = MLPHead(lstm_hid_ch, mlp_hid_ch, generator)

    def _node_features(self, op_x, meta_x, pred_x, pred_mask):
        op = torch.relu(self.op_nn(op_x))
        meta = torch.relu(self.meta_nn(meta_x))
        pred = self.pred_conv(pred_x, pred_mask)
        return torch.cat([op, meta, pred], dim=-1)

    def _step(self, child_h, feats):
        """One LSTM step from zero state: input = [child_h | feats]."""
        return self.cell(torch.cat([child_h, feats], dim=-1))

    def forward(self, leaf_pred_x, leaf_op_x, leaf_meta_x, node_pred_x,
                node_op_x, node_meta_x, node_valid, leaf_pred_mask=None,
                node_pred_mask=None):
        b, n_leaves = leaf_op_x.shape[:2]
        n_levels = node_op_x.shape[1]
        zeros_h = leaf_op_x.new_zeros((b, self.lstm_hid_ch))

        # All leaf hidden states at once, the leaves folded into the batch
        # axis: h_leaf = LSTM([0 | feats])
        def fold(t):
            return None if t is None else t.reshape(b * n_leaves,
                                                    *t.shape[2:])

        feats = self._node_features(fold(leaf_op_x), fold(leaf_meta_x),
                                    fold(leaf_pred_x), fold(leaf_pred_mask))
        leaf_hs = self._step(zeros_h.repeat_interleave(n_leaves, dim=0),
                             feats).reshape(b, n_leaves, self.lstm_hid_ch)

        # Chain: root_0 = leaf 0; level l combines (leaf_{l+1}, root_{l-1}).
        # A batch of single-table plans is padded to one level that no
        # chain has (node_valid all False) and that has no leaf to read.
        h = leaf_hs[:, 0]
        for level in range(min(n_levels, n_leaves - 1)):
            mask = (node_pred_mask[:, level] if node_pred_mask is not None
                    else None)
            feats = self._node_features(node_op_x[:, level],
                                        node_meta_x[:, level],
                                        node_pred_x[:, level], mask)
            child = (leaf_hs[:, level + 1] + h) / 2.0
            new_h = self._step(child, feats)
            valid = node_valid[:, level][:, None]
            h = torch.where(valid, new_h, h)
        return self.head(h)
