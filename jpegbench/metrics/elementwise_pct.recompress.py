"""``elementwise_pct.recompress``: the share of the window's kernel time
spent in kernels other than K1 (``dequant_idct_kernel``), K2
(``fdct_quant_kernel``) and K5 (``symbol_hist_kernel``): the colour
conversions both ways, the plane layout, upsampling, clamps, stacks and
casts around them. Read from the device trace, by kernel name."""

KERNELS = ("dequant_idct_kernel", "fdct_quant_kernel", "symbol_hist_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    kernels = ctx.trace.kernels()
    total = sum(float(e.get("dur", 0.0)) for e in kernels)
    if total <= 0.0:
        return None
    other = sum(float(e.get("dur", 0.0)) for e in kernels
                if not any(k in e["name"] for k in KERNELS))
    return 100.0 * other / total
