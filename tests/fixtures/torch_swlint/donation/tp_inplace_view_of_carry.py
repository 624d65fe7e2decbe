"""DN001: in-place methods and out= on views of the declared step's
carry."""
import torch


def packed_pipeline_step(tables, ps, bi, bf):
    sf = ps.sf[3:]
    sf.add_(bf[0])
    torch.mul(ps.si, 2, out=ps.si)
    return ps, bi, bf, bf
