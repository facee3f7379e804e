"""Serving: INT4 ViT forward, float reference, continuous batching."""

from .vit_int4 import (export_vit_int4, vit_int4_forward, QLayerArtifact,
                       random_vit_int4_artifact)
from .reference import vit_reference_forward
from .vit_tp import (permute_qkv_entry, prepare_tp_artifact,
                     shard_tp_artifact, tp_artifact_specs,
                     vit_int4_forward_tp)
from .vit_fsdp import (fsdp_artifact_specs, prepare_fsdp_artifact,
                       shard_fsdp_artifact, vit_int4_forward_fsdp)
from .batching import ContinuousBatcher, MultiHostFrontend
from .rpc import RpcBackendStub, RpcServingBackend

__all__ = ["export_vit_int4", "vit_int4_forward", "QLayerArtifact",
           "random_vit_int4_artifact", "vit_reference_forward",
           "ContinuousBatcher", "MultiHostFrontend", "permute_qkv_entry",
           "prepare_tp_artifact", "shard_tp_artifact", "tp_artifact_specs",
           "vit_int4_forward_tp", "fsdp_artifact_specs",
           "prepare_fsdp_artifact", "shard_fsdp_artifact",
           "vit_int4_forward_fsdp", "RpcBackendStub", "RpcServingBackend"]
