"""Float32 sums in the JAX package's order on the CPU.

The JAX package's CPU programs sum in an order that XLA's CPU compiler
fixes: a long reduction is cut into windows of 32 (its tree-reduction
rewrite) and a cumulative sum into blocks of 16 (its reduce-window
rewrite), each window or block added in order from 0.0. On the CPU the
port adds in that same order, so its split scans and bundle expansions
give the reference's bits, down to the near-ties on which a split can
part. On the card each function is one torch reduction or scan.
"""

import torch

SUM_WINDOW = 32   # XLA CPU tree-reduction window
SCAN_BLOCK = 16   # XLA CPU reduce-window (cumulative sum) block


def _in_order(x, dim, keep):
    """Running (keep=True) or final sum along `dim`, added in order."""
    acc = torch.zeros_like(x.select(dim, 0))
    out = [] if keep else None
    for k in range(x.shape[dim]):
        acc = acc + x.select(dim, k)
        if keep:
            out.append(acc)
    return torch.stack(out, dim) if keep else acc


def ordered_sum(x):
    """Sum over dim -2. On the CPU: up to SUM_WINDOW values in order; a
    longer axis zero-padded to whole windows (half the padding in
    front), each window summed in order, then the window totals the
    same way."""
    if x.device.type != "cpu":
        return x.sum(dim=-2)
    n = x.shape[-2]
    if n <= SUM_WINDOW:
        return _in_order(x, -2, keep=False)
    w = -(-n // SUM_WINDOW)
    lo = (w * SUM_WINDOW - n) // 2
    xp = x.new_zeros((*x.shape[:-2], w * SUM_WINDOW, x.shape[-1]))
    xp[..., lo:lo + n, :] = x
    xw = xp.reshape(*x.shape[:-2], w, SUM_WINDOW, x.shape[-1])
    return ordered_sum(_in_order(xw, -2, keep=False))


def ordered_cumsum(x):
    """Inclusive cumulative sum over dim -1. On the CPU: blocks of
    SCAN_BLOCK (the tail zero-padded), each a running sum in order, plus
    the exclusive cumulative sum of the block totals, itself computed so
    when there are more than SCAN_BLOCK blocks."""
    if x.device.type != "cpu":
        return torch.cumsum(x, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _in_order(x, -1, keep=True)
    nb = -(-n // SCAN_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, SCAN_BLOCK)
    within = _in_order(xb, -1, keep=True)
    incl = ordered_cumsum(within[..., -1])
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    return (within + excl[..., None]).reshape(
        *x.shape[:-1], nb * SCAN_BLOCK)[..., :n]
