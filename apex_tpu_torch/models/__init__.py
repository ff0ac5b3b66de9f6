"""Models (counterpart of ``apex_tpu.models``): GPT (serving and
training), BERT and the encoder-decoder (training)."""

from apex_tpu_torch.models.bert import BertModel
from apex_tpu_torch.models.encoder_decoder import EncoderDecoderModel
from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
)

__all__ = ["GPTModel", "BertModel", "EncoderDecoderModel",
           "TransformerConfig", "ParallelAttention", "ParallelMLP",
           "ParallelTransformer", "ParallelTransformerLayer"]
