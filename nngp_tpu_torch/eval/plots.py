"""Qualitative analysis plots (matplotlib, import-gated): a copy of
`nngp_tpu/eval/plots.py`, differing only in its imports.

Parity surfaces: kernel heatmap/histogram (`reference/util.py:27-65`,
`train.py:50-58`), uncertainty scatter (`util.py:73-92`), embedding scatter
(`util.py:67-71`), kernel-matrix permutation by query attributes
(`train.py:29-47`), and the standalone sklearn-GP demo plot (`draw.py`).
All functions take an explicit output path instead of the reference's cwd
side-effects; matplotlib is imported at the first drawing call. Arrays may
be numpy arrays or CPU tensors.
"""

import numpy as np

from nngp_tpu_torch.eval.qerror import PredictionStatistics


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise RuntimeError("matplotlib is required for plotting") from e


def permute_kernel_matrix(kernel_mat, query_infos, perm_keys):
    """Symmetric permutation by query attributes
    (`reference/train.py:29-38`)."""
    stat = PredictionStatistics()
    perm = stat.get_permutation_index(query_infos, perm_keys)
    k = np.asarray(kernel_mat)
    return k[np.ix_(perm, perm)]


def permute_train_test_kernel_matrix(kernel_mat, train_query_infos, perm_keys,
                                     pred_std):
    """Rows by test std, columns by train attributes
    (`reference/train.py:40-47`)."""
    stat = PredictionStatistics()
    train_perm = stat.get_permutation_index(train_query_infos, perm_keys)
    test_perm = np.argsort(np.asarray(pred_std))
    k = np.asarray(kernel_mat)
    return k[test_perm][:, train_perm]


def draw_kernel_heatmap(kernel_mat, output_path):
    plt = _plt()
    plt.figure(figsize=(8, 8), dpi=80)
    plt.imshow(np.asarray(kernel_mat), aspect="auto", cmap="viridis")
    plt.xticks([])
    plt.yticks([])
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()


def draw_kernel_histogram(kernel_mat, output_path, bins=100):
    plt = _plt()
    plt.figure()
    plt.hist(np.ravel(np.asarray(kernel_mat)), bins=bins)
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()


def draw_uncertainty(output_path, errors, uncertainty, y=None):
    """q-error (2^log2-error) vs uncertainty scatter
    (`reference/util.py:73-92`)."""
    plt = _plt()
    errors = np.power(2.0, np.ravel(np.asarray(errors)))
    uncertainty = np.ravel(np.asarray(uncertainty))
    plt.figure()
    c = np.ravel(np.asarray(y)) if y is not None else None
    plt.scatter(errors, uncertainty, s=20, c=c)
    plt.xscale("log")
    plt.xlabel("q-error")
    plt.ylabel("Coefficient of Variation")
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()


def draw_calibration(y_true, means, stds, output_path, num_intervals=10):
    """Expected-vs-observed confidence curve (reliability diagram) from
    `eval.calibration.calibration_table` — the drawn form of the table the
    reference prints per level (`reference/util.py:296-313`,
    `stats.norm.interval` over 10 levels). A perfectly calibrated posterior
    sits on the diagonal. Returns the table for programmatic use."""
    from nngp_tpu_torch.eval.calibration import calibration_table
    table = calibration_table(y_true, means, stds,
                              num_intervals=num_intervals)
    plt = _plt()
    expected = sorted(table)
    observed = [table[p] for p in expected]
    plt.figure(figsize=(5, 5))
    plt.plot([0, 1], [0, 1], "--", color="gray", label="perfect calibration")
    plt.plot(expected, observed, "o-", label="model")
    plt.xlabel("Expected confidence level")
    plt.ylabel("Observed confidence level")
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.legend()
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()
    return table


def draw_embeddings(embedding, output_path, label=None):
    plt = _plt()
    e = np.asarray(embedding)
    plt.figure()
    plt.scatter(e[:, 0], e[:, 1],
                c=np.ravel(np.asarray(label)) if label is not None else None)
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()
