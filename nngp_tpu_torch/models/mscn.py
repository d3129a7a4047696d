"""MSCN-family set-convolution models. Port of `nngp_tpu/models/mscn.py`.

  SetConvolution  per-element 2-layer MLP (ReLU after every layer,
                  including the last) + mean/min pool over the set
  MSCN            single-table: pred set conv -> MLP
  MSCNJoin        binary join: concat pred sets -> set conv;
                  join set conv; concat -> MLP
  MSCNMultiJoin   table/pred/join set convs -> MLP

Variable-size sets arrive zero-padded, and with mask=None the pooling runs
over the padded axis including the zero rows, as the original MSCN does; a
mask (True for real rows) gives the corrected pooling. The layers are
initialized as flax `Dense` layers (`models/baselines.py::dense`).
"""

from typing import Optional

import torch
from torch import nn

from nngp_tpu_torch.models.baselines import dense


class SetConvolution(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int, out_ch: int,
                 num_layers: int = 2, pool_type: str = "mean",
                 generator=None):
        super().__init__()
        if pool_type not in ("mean", "min"):
            raise ValueError(f"Unsupported pool type {pool_type!r}")
        self.pool_type = pool_type
        widths = [in_ch] + [hid_ch] * (num_layers - 1) + [out_ch]
        self.layers = nn.ModuleList(
            dense(a, b, generator) for a, b in zip(widths, widths[1:]))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        # x: (batch, set, feat); mask: (batch, set) True for real rows
        for layer in self.layers:
            x = torch.relu(layer(x))
        if self.pool_type == "mean":
            if mask is None:
                return torch.mean(x, dim=1)
            m = mask[..., None].to(x.dtype)
            return torch.sum(x * m, dim=1) / torch.sum(m, dim=1).clamp_min(1.0)
        if mask is None:
            return torch.amin(x, dim=1)
        # Finite sentinel, not inf: an all-padding set would min to inf
        # and inf/NaN leaks into gradients through where (0 * inf).
        big = torch.where(mask[..., None], x,
                          torch.full((), 1e30, dtype=x.dtype,
                                     device=x.device))
        pooled = torch.amin(big, dim=1)
        nonempty = torch.any(mask, dim=1)[..., None]
        return torch.where(nonempty, pooled, torch.zeros_like(pooled))


class MLPHead(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int, generator=None):
        super().__init__()
        self.fc1 = dense(in_ch, hid_ch, generator)
        self.fc2 = dense(hid_ch, 1, generator)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class MSCN(nn.Module):
    def __init__(self, pred_feat: int, pred_hid_ch: int = 64,
                 pred_out_ch: int = 64, mlp_hid_ch: int = 64, generator=None):
        super().__init__()
        self.pred_conv = SetConvolution(pred_feat, pred_hid_ch, pred_out_ch,
                                        generator=generator)
        self.head = MLPHead(pred_out_ch, mlp_hid_ch, generator)

    def forward(self, pred_x, pred_mask=None):
        return self.head(self.pred_conv(pred_x, pred_mask))


class MSCNJoin(nn.Module):
    def __init__(self, pred_feat: int, join_feat: int, pred_hid_ch: int = 64,
                 pred_out_ch: int = 64, join_hid_ch: int = 64,
                 join_out_ch: int = 64, mlp_hid_ch: int = 64, generator=None):
        super().__init__()
        self.pred_conv = SetConvolution(pred_feat, pred_hid_ch, pred_out_ch,
                                        generator=generator)
        self.join_conv = SetConvolution(join_feat, join_hid_ch, join_out_ch,
                                        generator=generator)
        self.head = MLPHead(pred_out_ch + join_out_ch, mlp_hid_ch, generator)

    def forward(self, left_pred_x, right_pred_x, join_x, pred_mask=None,
                join_mask=None):
        pred_x = torch.cat([left_pred_x, right_pred_x], dim=1)
        p = self.pred_conv(pred_x, pred_mask)
        j = self.join_conv(join_x, join_mask)
        return self.head(torch.cat([p, j], dim=1))


class MSCNMultiJoin(nn.Module):
    def __init__(self, table_feat: int, pred_feat: int, join_feat: int,
                 table_hid_ch: int = 64, table_out_ch: int = 64,
                 pred_hid_ch: int = 64, pred_out_ch: int = 64,
                 join_hid_ch: int = 64, join_out_ch: int = 64,
                 mlp_hid_ch: int = 64, generator=None):
        super().__init__()
        self.table_conv = SetConvolution(table_feat, table_hid_ch,
                                         table_out_ch, generator=generator)
        self.pred_conv = SetConvolution(pred_feat, pred_hid_ch, pred_out_ch,
                                        generator=generator)
        self.join_conv = SetConvolution(join_feat, join_hid_ch, join_out_ch,
                                        generator=generator)
        self.head = MLPHead(table_out_ch + pred_out_ch + join_out_ch,
                            mlp_hid_ch, generator)

    def forward(self, table_x, pred_x, join_x, table_mask=None,
                pred_mask=None, join_mask=None):
        t = self.table_conv(table_x, table_mask)
        p = self.pred_conv(pred_x, pred_mask)
        j = self.join_conv(join_x, join_mask)
        return self.head(torch.cat([t, p, j], dim=1))
