"""CLIP teacher loading: a torch checkpoint -> the port's CLIP towers.

Port of ``distillclip_tpu/models/teacher.py``.  The OpenAI checkpoints are
torchscript archives; plain ``torch.save`` state dicts are accepted too, so
tests and tools can fabricate teachers (``tools/fabricate_teacher.py``).  The
architecture's hyperparameters are inferred from the state dict, as the
reference does.

Weight layouts (torch checkpoint -> the port's parameters):

* Linear weight ``[out, in]``     -> ``kernel`` ``[in, out]`` (transposed: the
  port's ``Dense`` and its LN-prologue kernels read ``[in, out]``)
* conv1 weight ``[O, I, P, P]``   -> ``patch_kernel`` ``[(P P I), O]`` in
  ``patchify``'s pixel order
* fused ``in_proj_weight`` ``[3D, D]`` -> ``in_proj.kernel`` ``[D, 3D]`` (q, k, v
  order kept)
* LayerNorm ``weight`` / ``bias`` -> ``scale`` / ``bias``

The loaders return the module with the weights loaded as fp32, in eval mode
and without gradients, on ``device``.  A checkpoint without ``visual.proj`` is
an RN-class CLIP (RN50, RN101, RN50x4 ...): its image tower is a
:class:`models.resnet.ModifiedResNet` (``map_resnet_weights``), its text tower
the same transformer as a ViT checkpoint's.  A checkpoint in EVA-CLIP's layout
(``visual.blocks.{i}.attn.q_proj.weight`` ...) is an EVA-02-CLIP teacher: its
image tower is a :class:`models.eva_vit.EvaImageEncoder`
(``map_eva_visual_weights``: q, k, v fused, W1 and W2 interleaved, the SwiGLU
width padded to a multiple of 32), without taps; its text tower is not built.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.config.perf import require_module_kernels
from distillclip_tpu_torch.models.clip import CLIPModel
from distillclip_tpu_torch.models.encoders import ImageEncoder, TextEncoder
from distillclip_tpu_torch.models.eva_vit import (
    EvaImageEncoder,
    eva_visual_para,
    is_eva_state_dict,
    map_eva_visual_weights,
)
from distillclip_tpu_torch.models.resnet import ModifiedResNet, map_resnet_weights

# Official OpenAI CLIP checkpoint URLs.
MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models() -> List[str]:
    return list(MODELS.keys())


def download(url: str, root: str) -> str:
    """Download with SHA256 verification; an existing file that verifies is kept."""
    os.makedirs(root, exist_ok=True)
    filename = os.path.basename(url)
    expected_sha256 = url.split("/")[-2]
    target = os.path.join(root, filename)

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        with open(target, "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() == expected_sha256:
                return target
        warnings.warn(f"{target} exists but SHA256 mismatches; re-downloading")

    with urllib.request.urlopen(url) as source, open(target, "wb") as output:
        while True:
            buf = source.read(1 << 20)
            if not buf:
                break
            output.write(buf)
    with open(target, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != expected_sha256:
            raise RuntimeError("downloaded checkpoint fails SHA256 verification")
    return target


# -- state dict IO ------------------------------------------------------------------


def _is_torchscript(path: str) -> bool:
    """A torchscript archive is a zip that holds ``constants.pkl``; a plain
    ``torch.save`` zip does not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("constants.pkl") for n in z.namelist())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchscript archive or a plain ``torch.save`` checkpoint as fp32 CPU
    tensors by the checkpoint's own key names."""
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj)
    return {k: v.detach().float() for k, v in sd.items()}


def resolve_checkpoint(name: str, download_root: Optional[str] = None) -> str:
    """A model name or a path -> the local checkpoint path."""
    if name in MODELS:
        return download(MODELS[name], download_root or os.path.expanduser("~/.cache/clip"))
    if os.path.isfile(name):
        return name
    raise RuntimeError(f"Model {name} not found; available models = {available_models()}")


# -- hyperparameter inference ---------------------------------------------------------


def get_transformer_para(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {
        "output_dim": sd["text_projection"].shape[1],
        "context_length": sd["positional_embedding"].shape[0],
        "vocab_size": sd["token_embedding.weight"].shape[0],
        "width": sd["ln_final.weight"].shape[0],
        "heads": sd["ln_final.weight"].shape[0] // 64,
        "layers": len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}),
    }


def get_visual_para(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    if "visual.proj" not in sd:
        return _resnet_para(sd)
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return {
        "kind": "vit",
        "layers": len([k for k in sd
                       if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]),
        "width": vision_width,
        "patch_size": patch,
        "input_resolution": patch * grid,
        "heads": vision_width // 64,
        "output_dim": sd["text_projection"].shape[1],
    }


def _resnet_para(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    counts = [len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
              for b in (1, 2, 3, 4)]
    vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
    output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    assert output_width ** 2 + 1 == sd["visual.attnpool.positional_embedding"].shape[0]
    return {
        "kind": "resnet",
        "layers": tuple(counts),
        "width": vision_width,
        "input_resolution": output_width * 32,
        "heads": vision_width * 32 // 64,
        "output_dim": sd["text_projection"].shape[1],
    }


# -- weight mapping -----------------------------------------------------------------


def _ln(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.scale": sd[f"{src}.weight"], f"{dst}.bias": sd[f"{src}.bias"]}


def _linear(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    out = {f"{dst}.kernel": sd[f"{src}.weight"].t()}
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]
    return out


def _resblock(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {
        **_ln(sd, f"{src}.ln_1", f"{dst}.ln_1"),
        **_ln(sd, f"{src}.ln_2", f"{dst}.ln_2"),
        f"{dst}.attn.in_proj.kernel": sd[f"{src}.attn.in_proj_weight"].t(),
        f"{dst}.attn.in_proj.bias": sd[f"{src}.attn.in_proj_bias"],
        **_linear(sd, f"{src}.attn.out_proj", f"{dst}.attn.out_proj"),
        **_linear(sd, f"{src}.mlp.c_fc", f"{dst}.mlp.c_fc"),
        **_linear(sd, f"{src}.mlp.c_proj", f"{dst}.mlp.c_proj"),
    }


def _owned(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.contiguous().clone() for k, v in params.items()}


def map_visual_weights(sd: Dict[str, torch.Tensor], layers: int) -> Dict[str, torch.Tensor]:
    """``visual.*`` checkpoint keys -> the state dict of a ``VisionTransformer``."""
    conv = sd["visual.conv1.weight"]  # [O, I, P, P]
    O, I, P, _ = conv.shape
    params = {
        "patch_kernel": conv.permute(2, 3, 1, 0).reshape(P * P * I, O),
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        **_ln(sd, "visual.ln_pre", "ln_pre"),
        **_ln(sd, "visual.ln_post", "ln_post"),
        "proj": sd["visual.proj"],
    }
    for i in range(layers):
        params.update(_resblock(sd, f"visual.transformer.resblocks.{i}",
                                f"transformer.resblocks.{i}"))
    return _owned(params)


def map_text_weights(sd: Dict[str, torch.Tensor], layers: int) -> Dict[str, torch.Tensor]:
    """Text-tower checkpoint keys -> the state dict of a ``TextTransformer``."""
    params = {
        "token_embedding.embed.embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        **_ln(sd, "ln_final", "ln_final"),
        "text_projection": sd["text_projection"],
    }
    for i in range(layers):
        params.update(_resblock(sd, f"transformer.resblocks.{i}", f"transformer.resblocks.{i}"))
    return _owned(params)


# -- public loaders -----------------------------------------------------------------


def _frozen(module: nn.Module, device) -> nn.Module:
    require_module_kernels(module, device)
    return module.eval().requires_grad_(False).to(device)


def load_image_teacher(name: str, download_root: Optional[str] = None,
                       need_layers: Optional[Sequence[int]] = None,
                       device="cuda") -> nn.Module:
    """An ``ImageEncoder`` for a ViT checkpoint, a ``ModifiedResNet`` for an
    RN one (``need_layers`` does not apply to it), an ``EvaImageEncoder`` for
    an EVA-02-CLIP one (which takes no ``need_layers``)."""
    sd = load_torch_state_dict(resolve_checkpoint(name, download_root))
    if is_eva_state_dict(sd):
        if need_layers is not None:
            raise ValueError(f"teacher_need_layers {list(need_layers)}: the EVA-02-CLIP "
                             "teacher has no taps (its blocks return no hidden states, "
                             "scores or probabilities); set teacher_need_layers to null")
        para = eva_visual_para(sd)
        module = EvaImageEncoder(**para)
        module.visual.load_state_dict(map_eva_visual_weights(sd, para["layers"]), strict=True)
        return _frozen(module, device)
    para = get_visual_para(sd)
    if para.pop("kind") == "resnet":
        module = ModifiedResNet(**para)
        module.load_state_dict(map_resnet_weights(sd, para["layers"]), strict=True)
        return _frozen(module, device)
    module = ImageEncoder(is_student=False, need_layers=need_layers, **para)
    module.visual.load_state_dict(map_visual_weights(sd, para["layers"]), strict=True)
    return _frozen(module, device)


def load_text_teacher(name: str, download_root: Optional[str] = None,
                      need_layers: Optional[Sequence[int]] = None,
                      device="cuda") -> TextEncoder:
    sd = load_torch_state_dict(resolve_checkpoint(name, download_root))
    if is_eva_state_dict(sd):
        raise ValueError(f"{name}: the text tower of an EVA-02-CLIP checkpoint is not built "
                         "(it serves as a stage-1 image teacher only)")
    para = get_transformer_para(sd)
    module = TextEncoder(is_student=False, need_layers=need_layers, **para)
    module.text.load_state_dict(map_text_weights(sd, para["layers"]), strict=True)
    return _frozen(module, device)


def teacher_load(teacher_name: str, download_root: Optional[str] = None,
                 model_type: str = "image", need_layers: Optional[Sequence[int]] = None,
                 device="cuda") -> nn.Module:
    """The ``image`` or ``text`` teacher tower, or ``all``: both in a
    :class:`CLIPModel`."""
    if model_type == "text":
        return load_text_teacher(teacher_name, download_root, need_layers, device)
    if model_type == "image":
        return load_image_teacher(teacher_name, download_root, need_layers, device)
    if model_type == "all":
        return CLIPModel(
            image_tower=load_image_teacher(teacher_name, download_root, need_layers, device),
            text_tower=load_text_teacher(teacher_name, download_root, need_layers,
                                         device)).eval()
    raise ValueError(f"model_type must be image|text|all, got {model_type}")
