"""digit_matmul_roofline: the Ozaki digit kernel's (csrc/digit_matmul.cu)
least time from its shapes (roofline.digit_kernel_bound_s: int8
operations at the int8 peak, or its own bytes) over its device time by
name in the traced solve, %. Every launch in this sector's operator
multiplies a [ddw, ddw] or [dup, dup] operator's digits with a
[ddw, dup] vector's."""

from benchmark.roofline import PEAKS, digit_kernel_bound_s, ozaki_digits


def read(ctx):
    rec, tr = ctx.records, ctx.trace
    if tr is None or not rec.get("precision", "").startswith("ozaki") \
            or ctx.device_kind not in PEAKS:
        return None
    n = tr.kernel_count("digit_matmul")
    busy = tr.device_seconds("digit_matmul")
    if n == 0 or busy <= 0:
        return None
    ddw, dup = rec["shape"]
    p, _ = ozaki_digits(rec["precision"])
    per = 0.5 * (digit_kernel_bound_s(ddw, dup, ddw, p, ctx.device_kind)
                 + digit_kernel_bound_s(ddw, dup, dup, p, ctx.device_kind))
    return 100.0 * n * per / busy
