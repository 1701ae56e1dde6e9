from eigenkernel_tpu_torch.obs.events import EventLog

__all__ = ["EventLog"]
