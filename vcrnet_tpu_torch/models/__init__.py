from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_iter

__all__ = ["VCRNet", "vcrnet_iter"]
