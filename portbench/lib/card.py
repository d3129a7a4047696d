"""The card a run measures on: name, count, power limit, SM clock, its
maximum and the active throttle reasons, as nvidia-smi reports them.

`gpu_clocks` is a frozen copy of `nngp_tpu_torch/utils/profiling.py::
gpu_clocks`, with the power limit added to the fields it reads."""

import subprocess

_FIELDS = ("clocks.sm", "clocks.max.sm", "power.limit")
# the throttle reasons' field took a new name in newer nvidia-smi releases
_REASON_FIELDS = ("clocks_event_reasons.active",
                  "clocks_throttle_reasons.active")


def gpu_clocks(index=0):
    """{'sm_mhz', 'max_sm_mhz', 'power_limit_w', 'throttle_reasons'} as
    strings, or {'error': ...} when nvidia-smi cannot say."""
    err = ""
    for reasons in _REASON_FIELDS:
        fields = (*_FIELDS, reasons)
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={index}",
                 f"--query-gpu={','.join(fields)}",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            return {"error": repr(e)}
        if out.returncode == 0 and out.stdout.strip():
            values = [v.strip() for v in
                      out.stdout.strip().splitlines()[0].split(",")]
            return {"sm_mhz": values[0], "max_sm_mhz": values[1],
                    "power_limit_w": values[2],
                    "throttle_reasons": values[3]}
        err = (out.stderr or out.stdout).strip()
    return {"error": err}


def device_object(torch, chips):
    """The result line's `device`: platform, kind, count, the peak
    allocated bytes (read by the caller first) and the card's state."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(chips), **{f"card_{k}": v for k, v in
                                    gpu_clocks(0).items()}}
