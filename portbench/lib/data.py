"""The committed data a configuration or a traffic mix names, read and
checked against the sha256 each file has in that configuration or mix, so
that a change to the data cannot change what a cell measures unseen."""

import hashlib
import lzma
import os
import random


def read_lines(root, spec):
    """The non-blank lines, stripped, of the files of `spec`
    ({"dir": ..., "sha256": {file name: hex digest}}) in sorted file
    order; `.xz` files are decompressed in memory. Raises ValueError on a
    digest that differs."""
    lines = []
    for name in sorted(spec["sha256"]):
        path = os.path.join(root, spec["dir"], name)
        with open(path, "rb") as f:
            raw = f.read()
        digest = hashlib.sha256(raw).hexdigest()
        if digest != spec["sha256"][name]:
            raise ValueError(f"{path}: sha256 {digest}, the benchmark "
                             f"expects {spec['sha256'][name]}")
        if name.endswith(".xz"):
            raw = lzma.decompress(raw)
        lines.extend(l.strip() for l in raw.decode().splitlines()
                     if l.strip())
    return lines


def checked_dir(root, spec):
    """The directory of `spec`, after checking every file's digest."""
    read_lines(root, spec)
    return os.path.join(root, spec["dir"])


def split_order(lines, seed):
    """The lines in the order of the reference's train_test_val_split
    (`random.seed(seed)`, then a shuffle of the indices)."""
    idx = list(range(len(lines)))
    random.Random(seed).shuffle(idx)
    return [lines[i] for i in idx]


def strip_card(line):
    return line.rsplit("@", 1)[0]
