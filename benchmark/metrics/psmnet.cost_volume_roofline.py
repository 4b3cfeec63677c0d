"""``psmnet.cost_volume_roofline``: the cost-volume kernel's share of its byte
roofline (``csrc/cost_volume.cu``): its forward and backward launches'
bytes (``reference/psmnet.py`` ``cost_volume_bytes``, one way each) over
their device time. None where no launch of it ran."""

from benchmark import readers
from benchmark.reference import psmnet

KERNELS = ("cost_volume_fwd_kernel", "cost_volume_bwd_kernel")


def read(rec: dict) -> float | None:
    names = [n for n in rec["names_s"] if any(k in n for k in KERNELS)]
    launches = sum(rec["names_n"][n] for n in names)
    if not launches:
        return None
    cfg, mix = rec["cfg"], rec["mix"]
    nbytes = launches * psmnet.cost_volume_bytes(
        cfg, mix["batch"], readers.itemsize(cfg["compute_dtype"]["train"]))
    return readers.bytes_share(nbytes, sum(rec["names_s"][n] for n in names))
