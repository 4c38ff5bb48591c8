"""MMSS-GCNN: grid-feature image-caption grounding pretraining.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
mmss_gcnn.py`` (``MMSSStatics`` :32, ``mmss_statics_from_cfg`` :56,
``grid_region_inputs`` :98, ``spatial_dropout_select`` :130,
``MMSSGridModel`` :144).  The C5 map of a ResNet body is the grid of
region features; a random subset of at most ``SPATIAL_DROPOUT`` valid
cells per image is kept; the captions arrive tokenized
(``input_ids``, ``attention_mask``, ``special_tokens_mask``) and run
through the frozen BERT (with MLM corruption); a v2l projection maps
the regions to the language width, and the grounding and transformer
heads return their info and losses.  No NMS or RoIAlign runs here.

The random draws of one training forward are :class:`MMSSDraws`; a None
field is drawn from the generator, so a test can replay JAX's draws.
Statics may be built directly (narrow widths for the tests) or from a
config with :func:`mmss_statics_from_cfg`.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..backbone import ResNetBackbone, device_normalize
from ..language.bert import BertModel, WordEmbeddingBackbone, apply_mlm_masking
from ..layers import Linear
from ..mmss.grounding_head import AlignmentDraws, GroundingHead, GroundingStatics
from ..mmss.transformer_head import TransformerHead, TransformerHeadStatics
from ..roi_heads.bundle import compute_dtype
from ..rpn.rpn import top_k
from .statics import RCNNStatics, statics_from_cfg


class MMSSStatics(NamedTuple):
    backbone: RCNNStatics = RCNNStatics()
    v_dim: int = 2048
    l_dim: int = 768
    spatial_dropout: int = 100
    heads: Tuple[str, ...] = ("GroundingHead",)
    default_head: str = "GroundingHead"
    tie_vl: bool = False
    grounding: GroundingStatics = GroundingStatics()
    transformer: TransformerHeadStatics = TransformerHeadStatics()
    # language backbone
    lb_type: str = "BERT-Base"  # "BERT-Base" | "WordEmbedding"
    vocab_size: int = 30522
    bert_layers: int = 12
    bert_heads: int = 12
    bert_intermediate: int = 3072
    mlm: bool = True
    mlm_prob: float = 0.15
    mlm_prob_mask: float = 0.9
    mlm_prob_noise: float = 0.0
    mask_token_id: int = 103


def mmss_statics_from_cfg(cfg) -> MMSSStatics:
    h = cfg.MODEL.MMSS_HEAD
    g = h.GROUNDING
    t = h.TRANSFORMER
    bc = t.BERT_CONFIG
    return MMSSStatics(
        backbone=statics_from_cfg(cfg),
        v_dim=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        l_dim=768,
        spatial_dropout=h.SPATIAL_DROPOUT,
        heads=tuple(h.TYPES),
        default_head=h.DEFAULT_HEAD,
        tie_vl=h.TIE_VL_PROJECTION_WEIGHTS,
        grounding=GroundingStatics(
            local_metric=g.LOCAL_METRIC,
            global_metric=g.GLOBAL_METRIC,
            alignment=g.ALIGNMENT,
            temperature=g.ALIGNMENT_TEMPERATURE,
            loss_type=g.LOSS,
            negative_mining=g.NEGATIVE_MINING,
            margin=g.TRIPLET_MARGIN,
            align_words=g.ALIGN_WORDS_TO_REGIONS,
            align_regions=g.ALIGN_REGIONS_TO_WORDS,
        ),
        transformer=TransformerHeadStatics(
            num_layers=bc.num_hidden_layers,
            num_heads=bc.num_attention_heads,
            intermediate_size=bc.intermediate_size,
            hidden_size=bc.hidden_size,
            vocab_size=bc.vocab_size,
            layer_norm_eps=bc.layer_norm_eps,
            mmm_loss=t.MMM_LOSS,
            mlm=t.MASKED_LANGUAGE_MODELING,
        ),
        lb_type=cfg.MODEL.LANGUAGE_BACKBONE.TYPE,
        vocab_size=bc.vocab_size,
        mlm=t.MASKED_LANGUAGE_MODELING,
        mlm_prob=t.MASKED_LANGUAGE_MODELING_PROB,
        mlm_prob_mask=t.MASKED_LANGUAGE_MODELING_PROB_MASK,
        mlm_prob_noise=t.MASKED_LANGUAGE_MODELING_PROB_NOISE,
    )


def grid_region_inputs(features: torch.Tensor, image_sizes: torch.Tensor, padded_hw):
    """The grid cells as regions: ``[B, gh * gw, C]`` features, the mask
    of the cells inside each image and their normalized (x, y) centres,
    from the true image sizes."""
    b, gh, gw, dim = features.shape
    img_h, img_w = padded_hw
    dev = features.device
    sizes = image_sizes.to(dev, torch.float32)
    # tensor divisors: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal, an ulp away from JAX
    gs_h = torch.ceil(sizes[:, 0] * gh / torch.full((), float(img_h), device=dev)).to(torch.int32)
    gs_w = torch.ceil(sizes[:, 1] * gw / torch.full((), float(img_w), device=dev)).to(torch.int32)
    ys = torch.arange(gh, device=dev)[None, :, None]
    xs = torch.arange(gw, device=dev)[None, None, :]
    mask = (ys < gs_h[:, None, None]) & (xs < gs_w[:, None, None])
    loc_y = (ys + 0.5) / torch.clamp(gs_h[:, None, None], min=1)
    loc_x = (xs + 0.5) / torch.clamp(gs_w[:, None, None], min=1)
    loc = torch.stack([loc_x.expand(b, gh, gw), loc_y.expand(b, gh, gw)], dim=-1) * mask[..., None]
    return (
        features.reshape(b, gh * gw, dim),
        mask.reshape(b, gh * gw),
        loc.reshape(b, gh * gw, 2).to(torch.float32),
    )


def spatial_dropout_select(region_features, region_mask, region_loc, cap: int, uniforms: torch.Tensor):
    """Keeps ``cap`` cells per image, the valid ones with the smallest
    ``uniforms`` (``[B, N]`` in [0, 1)) first, then invalid cells (ties
    at 2.0 in index order, as ``lax.top_k`` breaks them)."""
    priority = torch.where(region_mask, uniforms, torch.full((), 2.0, device=uniforms.device))
    _, idx = top_k(-priority, cap)

    def take(a):
        return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]) if a.dim() == 3 else idx)

    return take(region_features), take(region_mask), take(region_loc)


class MMSSDraws(NamedTuple):
    """Random draws of one MMSS training forward; a None field is drawn
    from the generator.  ``dropout``: ``[B, gh * gw]`` uniforms of the
    spatial dropout; ``mlm_select``, ``mlm_mask`` (uniforms) and
    ``mlm_ids`` (ids in [0, vocab)): ``[B, W]``, the MLM corruption's;
    ``alignment``: the grounding head's :class:`AlignmentDraws`."""

    dropout: Optional[torch.Tensor] = None
    mlm_select: Optional[torch.Tensor] = None
    mlm_mask: Optional[torch.Tensor] = None
    mlm_ids: Optional[torch.Tensor] = None
    alignment: AlignmentDraws = AlignmentDraws()


class MMSSGridModel(nn.Module):
    """The MMSS pretraining model.  Its attributes are the flax scopes
    (``backbone``, ``language_backbone``, ``v2l_projection`` or
    ``v2l_projection_<head>``, ``transformer_head``), so ``bridge.py``
    maps the JAX parameter tree by path."""

    def __init__(self, statics: MMSSStatics):
        super().__init__()
        s = statics
        self.statics = s
        bs = s.backbone
        dtype = compute_dtype(bs)
        if not bs.conv_body.endswith(("-C4", "-C5")):
            raise NotImplementedError(f"CONV_BODY {bs.conv_body}: MMSS runs a C4 or C5 body")
        self.backbone = ResNetBackbone(
            depth=bs.conv_body[:-3],
            num_stages=4 if bs.conv_body.endswith("-C5") else 3,
            stem_out_channels=bs.stem_out_channels,
            res2_out_channels=bs.res2_out_channels,
            num_groups=bs.num_groups,
            width_per_group=bs.width_per_group,
            stride_in_1x1=bs.stride_in_1x1,
            res5_dilation=bs.res5_dilation,
            dtype=dtype,
        )
        self.full_bert = not (s.lb_type == "WordEmbedding" or "TransformerHead" not in s.heads)
        if self.full_bert:
            self.language_backbone = BertModel(
                vocab_size=s.vocab_size, hidden_size=s.l_dim, num_layers=s.bert_layers,
                num_heads=s.bert_heads, intermediate_size=s.bert_intermediate, dtype=dtype,
            )
        else:
            self.language_backbone = WordEmbeddingBackbone(vocab_size=s.vocab_size, hidden_size=s.l_dim)
        v_in = self.backbone.out_channels
        if s.tie_vl:
            self.v2l_projection = Linear(v_in, s.l_dim, dtype=dtype)
        else:
            for h in s.heads:
                setattr(self, f"v2l_projection_{h}", Linear(v_in, s.l_dim, dtype=dtype))
        if "GroundingHead" in s.heads:
            self.grounding_head = GroundingHead(s.grounding, s.l_dim, compute_dtype=dtype)
        if "TransformerHead" in s.heads:
            if not self.full_bert:
                raise ValueError("TransformerHead requires the full BERT language backbone")
            self.transformer_head = TransformerHead(s.transformer, s.l_dim, dtype=dtype)

    def _v2l(self, head: str) -> Linear:
        return self.v2l_projection if self.statics.tie_vl else getattr(self, f"v2l_projection_{head}")

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        captions: Dict[str, torch.Tensor],
        train: bool = True,
        draws: MMSSDraws = MMSSDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Returns ``(info, losses)``, as the JAX module does."""
        s = self.statics
        bs = s.backbone
        dev = images.device
        images = device_normalize(images, image_sizes, bs.pixel_mean, bs.pixel_std, bs.to_bgr255)
        feats = self.backbone(images)[0]
        region_features, region_mask, region_loc = grid_region_inputs(
            feats.to(torch.float32), image_sizes, images.shape[1:3]
        )
        if s.spatial_dropout > 0 and train:
            u = draws.dropout
            if u is None:
                u = torch.rand(region_mask.shape, generator=generator, device=dev)
            region_features, region_mask, region_loc = spatial_dropout_select(
                region_features, region_mask, region_loc,
                min(s.spatial_dropout, region_mask.shape[1]), u,
            )

        input_ids = captions["input_ids"].to(torch.int64)
        attention_mask = captions["attention_mask"]
        special_mask = captions["special_tokens_mask"]
        mlm_mask = torch.zeros(input_ids.shape, dtype=torch.bool, device=dev)
        if self.full_bert:
            ids_in = input_ids
            if s.mlm and train:
                shape = input_ids.shape

                def uniform(x):
                    return x if x is not None else torch.rand(shape, generator=generator, device=dev)

                ids = draws.mlm_ids
                if ids is None:
                    ids = torch.randint(0, s.vocab_size, shape, generator=generator, device=dev)
                ids_in, mlm_mask = apply_mlm_masking(
                    input_ids, special_mask, attention_mask,
                    uniform(draws.mlm_select), uniform(draws.mlm_mask), ids,
                    mask_token_id=s.mask_token_id, prob=s.mlm_prob,
                    prob_mask=s.mlm_prob_mask, prob_noise=s.mlm_prob_noise,
                )
            encoded_tokens, word_table = self.language_backbone(ids_in, attention_mask > 0)
            # grounding reads the raw word embeddings of the uncorrupted ids
            input_embeddings = word_table[input_ids]
        else:
            input_embeddings = self.language_backbone(input_ids)
            encoded_tokens = word_table = None

        caption_grounding_mask = attention_mask * (1 - special_mask)

        def v2l(head):
            return self._v2l(head)(region_features)

        info: Dict[str, torch.Tensor] = {}
        losses: Dict[str, torch.Tensor] = {}
        if "GroundingHead" in s.heads:
            o, l = self.grounding_head(
                v2l("GroundingHead"), region_mask, input_embeddings, caption_grounding_mask,
                draws=draws.alignment, generator=generator,
            )
            info.update(o)
            losses.update(l)
        if "TransformerHead" in s.heads:
            o, l = self.transformer_head(
                v2l("TransformerHead"), region_loc, region_mask, encoded_tokens, attention_mask,
                mlm_mask, input_ids, word_table,
            )
            info.update(o)
            losses.update(l)
        return info, losses
