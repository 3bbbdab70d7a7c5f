"""Learned span reader: the schema-free answering path.

Port of ``ahrag_tpu/models/reader``: a small transformer that points at answer
spans given (question, evidence), trained on meta-generated data whose
relation surfaces are randomized (``data.py``), so it can only learn the
relation-agnostic structure of the task.
"""
from ahrag_tpu_torch.models.reader.features import FeatureBatch, decode_span, featurize
from ahrag_tpu_torch.models.reader.model import ReaderConfig, SpanReader
