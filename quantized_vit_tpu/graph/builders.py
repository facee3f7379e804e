"""Pruning-dependency node groups for the model zoo.

The reference discovers these by tracing torch.jit -> ONNX and running the
"pzig" partition algorithm (dependency_graph/pruning_dependency.py:347-538,
graph/graph.py:107-267). A jaxpr carries no module identity, so the
JAX design goes the way SURVEY.md §7 recommends: each model family
declares its dependency structure from its config — which is exactly the
fixed point the reference's tracer computes for these architectures:

ViT (vit_model.py:211-328 topology):
- one *residual-stream* group containing every tensor whose out-dim is the
  embedding dim (patch_embed.proj, cls_token, pos_embed, all LayerNorms,
  attn.proj out, mlp.fc2 out, final norm). The reference marks
  patch_embed/pos_embed/head unprunable (train.py:337-341) and the
  connected-component growth then makes the entire stream one unprunable
  group — reproduced here directly with ``is_prunable=False``.
- per block: an attention group over the fused qkv with HEAD granularity
  (QKVMultiHeadAttentionOTO, operator.py:1132-1251: chained
  MULTIHEAD_HEADDIM/NUMHEAD transform = our Transform.QKV_HEADS), and an MLP
  hidden group over fc1 rows (fc2's in-dim follows at compression time —
  pruning_compression.py:227-241).
- head / pre_logits: adjacent to model output -> unprunable
  (pruning_dependency.py:395-400).
- each quantized layer's d/q_m/t scalars ride along as NO_PRUNE entries
  (operator.py:1169-1186).

UltraNet (mymodel.py:62-143 topology): per conv block a channel group
(conv kernel out-dim + BN scale/bias as ACCESSORY — BatchNormOTO,
operator.py:352-384); the next conv's in-dim follows at compression. The
final 1x1 conv feeds the YOLO head -> unprunable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..models.ultranet import ULTRANET_LAYERS
from ..models.vit import ViTConfig
from ..opt.groups import (NodeGroup, ParamEntry, Transform,
                          get_path, has_path)

_QUANT_NAMES = ("d_quant_wt", "q_m_wt", "t_quant_wt",
                "d_quant_act", "q_m_act", "t_quant_act")


def _layer_entries(params, layer: str, kernel_tf: Transform,
                   bias_tf: Transform = Transform.ACCESSORY,
                   with_quant: bool = True) -> List[ParamEntry]:
    out = [ParamEntry(f"{layer}/kernel", kernel_tf)]
    if has_path(params, f"{layer}/bias"):
        out.append(ParamEntry(f"{layer}/bias", bias_tf))
    if with_quant:
        for q in _QUANT_NAMES:
            if has_path(params, f"{layer}/{q}"):
                out.append(ParamEntry(f"{layer}/{q}", Transform.NO_PRUNE))
    return out


def _ln_entries(params, path: str) -> List[ParamEntry]:
    out = []
    for nm in ("scale", "bias"):
        if has_path(params, f"{path}/{nm}"):
            out.append(ParamEntry(f"{path}/{nm}", Transform.ACCESSORY))
    return out


def vit_node_groups(cfg: ViTConfig, params,
                    unprunable_extra: Optional[List[str]] = None
                    ) -> List[NodeGroup]:
    """Node groups for the VisionTransformer family."""
    unprunable_extra = set(unprunable_extra or [])
    groups: List[NodeGroup] = []

    # Residual stream (unprunable)
    stream: List[ParamEntry] = []
    stream += _layer_entries(params, "patch_embed/proj", Transform.OUT)
    stream.append(ParamEntry("cls_token", Transform.OUT))
    stream.append(ParamEntry("pos_embed", Transform.OUT))
    for i in range(cfg.depth):
        stream += _ln_entries(params, f"blocks_{i}/norm1")
        stream += _ln_entries(params, f"blocks_{i}/norm2")
        stream += _layer_entries(params, f"blocks_{i}/attn/proj", Transform.OUT)
        stream += _layer_entries(params, f"blocks_{i}/mlp/fc2", Transform.OUT)
    stream += _ln_entries(params, "norm")
    groups.append(NodeGroup(
        id="residual_stream", entries=stream,
        num_groups=cfg.embed_dim, is_prunable=False,
    ))

    # per-block sizes come from the PARAM SHAPES, not dense config
    # constants, so re-wrapping a GETA-compressed model in OTO (e.g. the
    # post-training metrics pass, train.py:552-606 analogue) groups
    # correctly instead of reusing stale head/hidden counts
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        qkv = f"blocks_{i}/attn/qkv"
        heads_i = get_path(params, f"{qkv}/kernel").shape[-1] // (
            3 * head_dim)
        groups.append(NodeGroup(
            id=f"blocks_{i}/attn",
            entries=[
                ParamEntry(f"{qkv}/kernel", Transform.QKV_HEADS),
                *([ParamEntry(f"{qkv}/bias", Transform.QKV_HEADS)]
                  if has_path(params, f"{qkv}/bias") else []),
                *[ParamEntry(f"{qkv}/{q}", Transform.NO_PRUNE)
                  for q in _QUANT_NAMES if has_path(params, f"{qkv}/{q}")],
            ],
            num_groups=heads_i,
            num_heads=heads_i,
            is_prunable=f"blocks_{i}/attn" not in unprunable_extra,
        ))
        groups.append(NodeGroup(
            id=f"blocks_{i}/mlp",
            entries=_layer_entries(params, f"blocks_{i}/mlp/fc1",
                                   Transform.OUT),
            num_groups=get_path(
                params, f"blocks_{i}/mlp/fc1/kernel").shape[-1],
            is_prunable=f"blocks_{i}/mlp" not in unprunable_extra,
        ))

    if has_path(params, "pre_logits"):
        groups.append(NodeGroup(
            id="pre_logits",
            entries=_layer_entries(params, "pre_logits", Transform.OUT),
            num_groups=cfg.representation_size or cfg.embed_dim,
            is_prunable=False,  # feeds head (adjacent to output)
        ))
    if has_path(params, "head"):
        groups.append(NodeGroup(
            id="head",
            entries=_layer_entries(params, "head", Transform.OUT),
            num_groups=cfg.num_classes,
            is_prunable=False,  # adjacent to model output
        ))
    return groups


def ultranet_node_groups(params, batch_stats=None) -> List[NodeGroup]:
    """Channel groups for UltraNet: conv_i out-channels + bn_i scale/bias.

    BN running stats live in flax's ``batch_stats`` collection, not in
    params; compression slices them via the same kept-index maps
    (compress/).
    """
    groups: List[NodeGroup] = []
    n = len(ULTRANET_LAYERS)
    for i in range(n):
        # channel count from the kernel shape so compressed subnets
        # re-group correctly
        feat = get_path(params, f"conv_{i}/kernel").shape[-1]
        entries = [ParamEntry(f"conv_{i}/kernel", Transform.OUT)]
        for nm in ("scale", "bias"):
            if has_path(params, f"bn_{i}/{nm}"):
                entries.append(ParamEntry(f"bn_{i}/{nm}", Transform.ACCESSORY))
        groups.append(NodeGroup(
            id=f"conv_{i}", entries=entries, num_groups=feat,
            is_prunable=True,
        ))
    # Final conv: YOLO head output — unprunable (adjacent to output)
    entries = [ParamEntry(f"conv_{n}/kernel", Transform.OUT)]
    if has_path(params, f"conv_{n}/bias"):
        entries.append(ParamEntry(f"conv_{n}/bias", Transform.ACCESSORY))
    groups.append(NodeGroup(
        id=f"conv_{n}", entries=entries,
        num_groups=36, is_prunable=False,
    ))
    return groups


def lora_layer_entries(params, layer: str) -> List[ParamEntry]:
    """Entries for a LoraDense layer (LoraLinearOTO, operator.py:521-560):
    base kernel + lora_b prune out-rows together; lora_a is NO_PRUNE; bias
    rides as ACCESSORY."""
    out = [ParamEntry(f"{layer}/kernel", Transform.OUT),
           ParamEntry(f"{layer}/lora_b", Transform.OUT),
           ParamEntry(f"{layer}/lora_a", Transform.NO_PRUNE)]
    if has_path(params, f"{layer}/bias"):
        out.append(ParamEntry(f"{layer}/bias", Transform.ACCESSORY))
    return out


def lora_embedding_entries(params, layer: str) -> List[ParamEntry]:
    """Entries for a LoraEmbedding layer (LoraEmbeddingOTO,
    operator.py:592-674): the base table and lora_b prune the feature dim
    together (torch layout prunes embedding dim=1 via TRANSPOSE; flax puts
    features last, so both are Transform.OUT); lora_a is NO_PRUNE."""
    return [ParamEntry(f"{layer}/embedding", Transform.OUT),
            ParamEntry(f"{layer}/lora_b", Transform.OUT),
            ParamEntry(f"{layer}/lora_a", Transform.NO_PRUNE)]


def resnet_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups for the residual CNN family (models/resnet.py).

    Mirrors what the reference's pzig partition computes on a torchvision
    ResNet (pruning_dependency.py steps 1-4): the residual ADDITIONS of one
    stage form a connected component, so every conv feeding a skip sum —
    conv2 of each block, the stage's 1x1 downsample conv, and (for the first
    stage) the stem conv — shares ONE pruning decision per stage
    ("stream_{s}" groups). Each block's conv1 prunes independently
    ("stage{s}_block{b}" groups), with conv2's in-dim following at
    compression time. BN scale/bias ride as ACCESSORY (BatchNormOTO,
    operator.py:352-384); quant scalars as NO_PRUNE. The head is adjacent
    to the model output -> unprunable (pruning_dependency.py:395-400).
    """
    groups: List[NodeGroup] = []
    for s, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        stream_entries: List[ParamEntry] = []
        if s == 0:
            stream_entries += _layer_entries(params, "stem_conv",
                                             Transform.OUT)
            stream_entries += _ln_entries(params, "stem_bn")
        for b in range(n_blocks):
            blk = f"stage{s}_block{b}"
            groups.append(NodeGroup(
                id=blk,
                entries=(_layer_entries(params, f"{blk}/conv1",
                                        Transform.OUT)
                         + _ln_entries(params, f"{blk}/bn1")),
                num_groups=cfg.block_inner(s, b),
                is_prunable=True,
            ))
            stream_entries += _layer_entries(params, f"{blk}/conv2",
                                             Transform.OUT)
            stream_entries += _ln_entries(params, f"{blk}/bn2")
            if has_path(params, f"{blk}/down_conv/kernel"):
                stream_entries += _layer_entries(params, f"{blk}/down_conv",
                                                 Transform.OUT)
                stream_entries += _ln_entries(params, f"{blk}/down_bn")
        groups.append(NodeGroup(
            id=f"stream_{s}", entries=stream_entries,
            num_groups=width, is_prunable=True,
        ))
    groups.append(NodeGroup(
        id="head",
        entries=_layer_entries(params, "head", Transform.OUT),
        num_groups=cfg.num_classes,
        is_prunable=False,  # adjacent to output
    ))
    return groups


def mobilenet_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups for the depthwise-separable family (models/mobilenet.py).

    Mirrors the reference's depthwise-conv merge (pruning_dependency.py:
    203-238): a depthwise conv's per-channel kernels can't pick their own
    channels, so they join the PRODUCING layer's group — here each group
    spans (producing conv kernel out-dim, its BN, the following depthwise
    kernel's channel axis, the depthwise BN); the next pointwise conv's
    in-dim follows at compression time. The last pointwise group feeds GAP
    -> head, whose in-dim also follows; head itself is unprunable
    (adjacent to output, pruning_dependency.py:395-400).
    """
    groups: List[NodeGroup] = []
    n = len(cfg.widths)

    def channel_group(gid, producer, producer_bn, width, dw=None):
        entries = _layer_entries(params, producer, Transform.OUT)
        entries += _ln_entries(params, producer_bn)
        if dw is not None:
            # depthwise kernel [k, k, 1, C]: channel axis is last -> OUT
            entries += _layer_entries(params, f"dw_{dw}", Transform.OUT)
            entries += _ln_entries(params, f"dw_bn_{dw}")
        return NodeGroup(id=gid, entries=entries, num_groups=width,
                         is_prunable=True)

    groups.append(channel_group(
        "stem", "stem_conv", "stem_bn",
        get_path(params, "stem_conv/kernel").shape[-1], dw=0))
    for i in range(n):
        nxt = i + 1 if i + 1 < n else None
        groups.append(channel_group(
            f"pw_{i}", f"pw_{i}", f"pw_bn_{i}",
            get_path(params, f"pw_{i}/kernel").shape[-1], dw=nxt))
    groups.append(NodeGroup(
        id="head", entries=_layer_entries(params, "head", Transform.OUT),
        num_groups=cfg.num_classes, is_prunable=False,
    ))
    return groups


def transformer_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups for the separate-q/k/v TransformerEncoder family.

    Mirrors what the reference's pzig partition computes for Bert/Llama-style
    attention (BaseMultiHeadAttentionOTO, operator.py:810-975 and
    BertAttention :1012-1130): one HEAD-granularity group per block spanning
    the q, k, v projections TOGETHER (their out rows must keep the same
    heads), with proj's in-dim following at compression time; an MLP hidden
    group per block; the token embedding / position embedding / LayerNorms /
    proj / fc2 outs form the residual stream (unprunable here, matching the
    reference marking embeddings unprunable, pruning_dependency.py:388-424);
    head adjacent to output -> unprunable. Embedding feature axis is LAST in
    flax, so Transform.OUT replaces the torch TRANSPOSE (operator.py:677-706).
    """
    groups: List[NodeGroup] = []

    stream: List[ParamEntry] = [
        ParamEntry("embed/embedding", Transform.OUT),
        ParamEntry("pos_embed", Transform.OUT),
    ]
    for i in range(cfg.depth):
        stream += _ln_entries(params, f"blocks_{i}/norm1")
        stream += _ln_entries(params, f"blocks_{i}/norm2")
        stream += _layer_entries(params, f"blocks_{i}/attn/proj",
                                 Transform.OUT)
        stream += _layer_entries(params, f"blocks_{i}/fc2", Transform.OUT)
    stream += _ln_entries(params, "norm")
    groups.append(NodeGroup(
        id="residual_stream", entries=stream,
        num_groups=cfg.embed_dim, is_prunable=False,
    ))

    # GQA (models/transformer.py num_kv_heads): the prunable unit is the KV
    # head — its q_per_kv query heads live or die with it, so all three
    # projections group at KV granularity (q's groups are contiguous
    # q_per_kv*head_dim runs, which is exactly Transform.HEADS with
    # num_heads=kv). MHA is the kv == num_heads special case.
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        # per-block kv count from the k kernel shape (compressed subnets)
        kv_i = get_path(
            params, f"blocks_{i}/attn/k/kernel").shape[-1] // head_dim
        entries: List[ParamEntry] = []
        for nm in ("q", "k", "v"):
            layer = f"blocks_{i}/attn/{nm}"
            entries.append(ParamEntry(f"{layer}/kernel", Transform.HEADS))
            if has_path(params, f"{layer}/bias"):
                entries.append(ParamEntry(f"{layer}/bias", Transform.HEADS))
            for q in _QUANT_NAMES:
                if has_path(params, f"{layer}/{q}"):
                    entries.append(ParamEntry(f"{layer}/{q}",
                                              Transform.NO_PRUNE))
        groups.append(NodeGroup(
            id=f"blocks_{i}/attn", entries=entries,
            num_groups=kv_i, num_heads=kv_i,
            is_prunable=True,
        ))
        # SwiGLU: gate and up (fc1) kernels share the hidden rows — ONE
        # pruning decision spans both (the Llama MLP case; fc2's in-dim
        # follows at compression like the plain-GELU fc2<-fc1 link)
        mlp_entries = _layer_entries(params, f"blocks_{i}/fc1",
                                     Transform.OUT)
        if has_path(params, f"blocks_{i}/gate"):
            mlp_entries += _layer_entries(params, f"blocks_{i}/gate",
                                          Transform.OUT)
        groups.append(NodeGroup(
            id=f"blocks_{i}/mlp",
            entries=mlp_entries,
            num_groups=get_path(
                params, f"blocks_{i}/fc1/kernel").shape[-1],
            is_prunable=True,
        ))

    if has_path(params, "head/kernel"):
        groups.append(NodeGroup(
            id="head", entries=_layer_entries(params, "head", Transform.OUT),
            num_groups=cfg.num_classes, is_prunable=False,
        ))
    return groups


def autoencoder_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups for the ConvAutoencoder family (models/autoencoder.py) —
    ConvTranspose + GroupNorm pruning support.

    Mirrors the reference operators ConvTranspose2dOTO (operator.py:291-349)
    and GroupNorm/InstanceNorm (operator.py:387-457) plus the pzig SPREAD
    overwrite (pruning_dependency.py:426-538): a conv followed by a
    GroupNorm(G) prunes in units of whole norm groups, so the node group's
    ``num_groups`` is G and each pruning group spans a contiguous run of
    C/G channels (Transform.OUT with coarse granularity). The GroupNorm
    scale/bias ride as ACCESSORY; each layer's in-dim follows at compression
    time. The output conv is adjacent to the model output -> unprunable.
    """
    groups: List[NodeGroup] = []

    def conv_group(layer: str, gn: str, norm_groups: int):
        entries = _layer_entries(params, layer, Transform.OUT)
        entries += _ln_entries(params, gn)
        return NodeGroup(id=layer, entries=entries, num_groups=norm_groups,
                         is_prunable=True)

    for i in range(len(cfg.widths)):
        groups.append(conv_group(f"enc_{i}", f"enc_gn_{i}",
                                 cfg.enc_groups(i)))
    for i in range(len(cfg.decoder_widths)):
        groups.append(conv_group(f"dec_{i}", f"dec_gn_{i}",
                                 cfg.dec_groups(i)))
    groups.append(NodeGroup(
        id="out_conv",
        entries=_layer_entries(params, "out_conv", Transform.OUT),
        num_groups=cfg.in_channels, is_prunable=False,
    ))
    return groups


def mark_unprunable(groups: List[NodeGroup], param_names: List[str]
                    ) -> List[NodeGroup]:
    """Disable pruning for any group containing one of the given param paths
    (OTO.mark_unprunable_by_param_names, __init__.py:403-413)."""
    for g in groups:
        for e in g.entries:
            if any(nm in e.path for nm in param_names):
                g.is_prunable = False
                break
    return groups
