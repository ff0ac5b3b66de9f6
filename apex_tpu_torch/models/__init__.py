"""Models (counterpart of ``apex_tpu.models``): GPT (serving and
training), BERT and the encoder-decoder (training), and the ResNet family
(training on the fused conv + batch-norm path)."""

from apex_tpu_torch.models.bert import BertModel
from apex_tpu_torch.models.encoder_decoder import EncoderDecoderModel
from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
)

__all__ = ["GPTModel", "BertModel", "EncoderDecoderModel",
           "TransformerConfig", "ParallelAttention", "ParallelMLP",
           "ParallelTransformer", "ParallelTransformerLayer", "ResNet",
           "ResNetConfig", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
