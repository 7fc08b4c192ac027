from .pipeline import DataConfig, SyntheticLM, make_batch_fn, place_batch

__all__ = ["DataConfig", "SyntheticLM", "make_batch_fn", "place_batch"]
