"""``keyed_flag``: a 0/1 attribute of a key, read at each row: for every key
0..``keys``-1 one integer uniform in ``range`` = [lo, hi), flagged where it
lies in ``flag_in`` = [lo, hi); the row reads its key ``key``'s flag.  With
``range`` [0, 150) and ``flag_in`` [125, 150) this is dbgen's ``p_type LIKE
'PROMO%'`` (the first of its three syllables PROMO, one type in six)."""

import torch


def make(spec, ctx):
    lo, hi = spec["range"]
    t = torch.randint(int(lo), int(hi), (int(spec["keys"]),), generator=ctx.g,
                      device=ctx.device, dtype=torch.int64)
    flo, fhi = spec["flag_in"]
    flag = ((t >= int(flo)) & (t < int(fhi))).to(torch.int64)
    return flag[ctx.cols[spec["key"]].long()]
