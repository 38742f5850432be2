from vcrnet_tpu_torch.models.dcp import DCP
from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_iter

__all__ = ["DCP", "VCRNet", "vcrnet_iter"]
