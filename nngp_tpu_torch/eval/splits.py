"""Dataset splits with index math identical to the reference.

A copy of `nngp_tpu/eval/splits.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

`train_test_val_split` reproduces `reference/util.py:271-293` exactly —
same stdlib `random.seed(seed); random.shuffle(indices)` sequence, same 60/20/20
slicing — so a fixed seed selects the *same* train/test queries as the
reference run, which is what makes q-error parity a meaningful gate
(SURVEY.md section 6).
"""

import random
from typing import Optional, Sequence

import numpy as np


def train_test_val_split(x, y, train_frac=0.6, test_frac=0.2, seed=10,
                         all_query_infos: Optional[Sequence] = None,
                         max_num_train: Optional[int] = None):
    num = x.shape[0]
    num_train, num_test = int(train_frac * num), int(test_frac * num)
    indices = list(range(num))
    random.seed(seed)
    random.shuffle(indices)
    x, y = x[indices, :], y[indices, :]
    infos = [all_query_infos[i] for i in indices] if all_query_infos is not None else None

    x_train, y_train = x[:num_train], y[:num_train]
    x_test, y_test = x[num_train:num_train + num_test], y[num_train:num_train + num_test]
    has_val = train_frac + test_frac < 1
    x_val = x[num_train + num_test:] if has_val else None
    y_val = y[num_train + num_test:] if has_val else None
    infos_train = infos[:num_train] if infos is not None else None
    infos_test = infos[num_train:num_train + num_test] if infos is not None else None
    infos_val = infos[num_train + num_test:] if infos is not None and has_val else None
    if max_num_train is not None and max_num_train <= num_train:
        x_train, y_train = x_train[:max_num_train], y_train[:max_num_train]
        infos_train = infos_train[:max_num_train] if infos_train is not None else None
    return (x_train, y_train, infos_train,
            x_test, y_test, infos_test,
            x_val, y_val, infos_val)


def uneven_train_test_split(x, y, all_query_infos, skew_split_keys,
                            train_frac=0.6, skew_ratio=0.5, seed=10):
    """Skewed train composition across attribute partitions
    (`reference/util.py:220-268`)."""
    from nngp_tpu_torch.eval.qerror import PredictionStatistics

    random.seed(seed)
    stat = PredictionStatistics()
    partition = stat.get_partitioned_indices(all_query_infos, skew_split_keys)
    num_parts = len(partition)
    train_idx_by_key = {}
    test_idx = []
    for key in sorted(partition.keys()):
        random.shuffle(partition[key])
        num_train = int(len(partition[key]) * train_frac)
        test_idx += partition[key][num_train:]
        train_idx_by_key[key] = partition[key][:num_train]

    train_idx = []
    for i, key in enumerate(sorted(train_idx_by_key.keys())):
        if num_parts % 2 == 0:
            ratio = skew_ratio if i < num_parts // 2 else 1.0 - skew_ratio
        else:
            if i < num_parts // 2:
                ratio = skew_ratio
            elif i == num_parts // 2:
                ratio = 0.5
            else:
                ratio = 1.0 - skew_ratio
        keep = int(len(train_idx_by_key[key]) * ratio)
        train_idx += train_idx_by_key[key][:keep]

    x_train = x[np.asarray(train_idx, dtype=int)]
    y_train = y[np.asarray(train_idx, dtype=int)]
    x_test = x[np.asarray(test_idx, dtype=int)]
    y_test = y[np.asarray(test_idx, dtype=int)]
    infos_train = [all_query_infos[i] for i in train_idx]
    infos_test = [all_query_infos[i] for i in test_idx]
    return (x_train, y_train, infos_train, x_test, y_test, infos_test,
            None, None, None)
