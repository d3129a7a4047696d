"""The numbers that decide `correct`: gaps between what the program
answered and what the reference answers, on the same rows.

mean_gap: the widest |mean - reference mean| over the rows, in log2
cardinality (the estimate's own unit: a gap of g is a factor 2^g).
std_gap: the widest |std - reference std| / max(reference std, the
median reference std); the floor keeps rows the train set pins to a
near-zero std from turning rounding into a large share.
mean_gap_median, std_gap_median: the medians of the same gaps over the
rows: steady from seed to seed where a few rows' widest gap swings (an
fp32 fit's whitening amplifies its rounding on a few rows), so a small
error spread over every row still shows.
"""

import torch


def gaps(mean, std, ref_mean, ref_std):
    """The four gaps of 1-D tensors, by name."""
    f64 = torch.float64
    mean, std = mean.to(f64), std.to(f64)
    ref_mean, ref_std = ref_mean.to(f64), ref_std.to(f64)
    names = ("mean_gap", "std_gap", "mean_gap_median", "std_gap_median")
    if not (bool(torch.isfinite(mean).all())
            and bool(torch.isfinite(std).all())):
        return dict.fromkeys(names, float("inf"))
    floor = torch.clamp_min(ref_std, torch.median(ref_std))
    dm = torch.abs(mean - ref_mean)
    ds = torch.abs(std - ref_std) / floor
    return dict(zip(names, (float(torch.max(dm)), float(torch.max(ds)),
                            float(torch.median(dm)),
                            float(torch.median(ds)))))


def rel_gap(got, want):
    """max |got - want| / max |want|, in fp64 (inf where got is not
    finite)."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(torch.max(torch.abs(got - want))
                 / torch.max(torch.abs(want)))


def verdict(readings, limits):
    """(correct, check): every reading at or under its limit; check maps
    each name to its value and limit, in the limits' order. A reading
    that is missing or not a number fails."""
    check, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        check[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, check
