from .pipeline import SyntheticLM, make_batches, pack_documents  # noqa: F401
