"""The host-to-device copies' share of their roofline in the traced train
segment: the least time the bytes the Trainer shipped in it could take
(the program's ``h2d_bytes`` counter at the ends of the tracer's last
recording interval, which is the segment, at ``H2D_PEAK``) over the
``Memcpy HtoD`` time the device trace gives; the largest over the ranks.
Nothing where the program has no tracer or no such counter, or where no
copy ran."""

#: Bytes/s of one direction of the H100 SXM's host link: PCIe Gen5 x16,
#: 128 GB/s both directions (NVIDIA H100 Tensor Core GPU data sheet).
H2D_PEAK = 64e9


def read(rec):
    if rec['kind'] != 'train' or not rec['traces']:
        return None
    try:
        from gltvae_torch import trace
    except ImportError:         # a program without the tracer
        return None
    last = {iv['rank']: iv for iv in trace.intervals()}
    shares = []
    for rank, iv in last.items():
        stop = iv['stop'] or trace.snapshot()
        if rank >= len(rec['traces']) or 'h2d_bytes' not in stop \
                or 'h2d_bytes' not in iv['start']:
            continue
        shipped = stop['h2d_bytes'] - iv['start']['h2d_bytes']
        spent = rec['traces'][rank]['h2d_ns'] / 1e9
        if shipped > 0 and spent > 0:
            shares.append(100.0 * shipped / H2D_PEAK / spent)
    return max(shares) if shares else None
