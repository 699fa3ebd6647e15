from repro_torch.checkpoint.store import AsyncSaver, latest_step, load, save

__all__ = ["AsyncSaver", "latest_step", "load", "save"]
