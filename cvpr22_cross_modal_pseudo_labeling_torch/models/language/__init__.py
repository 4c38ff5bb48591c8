"""Language backbones.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/language/
__init__.py``: :func:`build_language_backbone` (:11) builds the backbone
``MODEL.LANGUAGE_BACKBONE.TYPE`` names, ``BERT-Base`` (the 12-layer
encoder) or ``WordEmbedding`` (the table alone).
"""

from .bert import BertEncoder, BertModel, WordEmbeddingBackbone, apply_mlm_masking


def build_language_backbone(cfg):
    t = cfg.MODEL.LANGUAGE_BACKBONE.TYPE
    bc = cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG
    if t == "BERT-Base":
        return BertModel(vocab_size=bc.vocab_size, hidden_size=bc.hidden_size, num_layers=12,
                         num_heads=12, intermediate_size=3072)
    if t == "WordEmbedding":
        return WordEmbeddingBackbone(vocab_size=bc.vocab_size, hidden_size=bc.hidden_size)
    raise ValueError(f"Unknown LANGUAGE_BACKBONE.TYPE {t}")


__all__ = ["BertEncoder", "BertModel", "WordEmbeddingBackbone", "apply_mlm_masking",
           "build_language_backbone"]
