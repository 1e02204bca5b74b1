"""Diffusers snapshot loader (counterpart of sduss_tpu/models/loader.py).

Reads a pipeline snapshot as diffusers lays it out: ``model_index.json``,
then one directory per component (``unet/`` or ``transformer/``,
``text_encoder*/``, ``vae/``) holding safetensors files, single or
sharded, and ``tokenizer*/`` directories.  The port keeps diffusers'
tensor names in torch layout, so each component loads its module's keys
as they are (``registry.select_state_dict``); no converter runs.

The safetensors reader is the port's own: the format is an 8-byte
little-endian header length, a JSON header, then raw little-endian
bytes, and a reader of a few lines runs wherever torch does, with no
``safetensors`` package.  Tokenizers come from ``transformers`` when it is
installed and the snapshot has them; otherwise the deterministic hash stub
(``registry.StubTokenizer``) keeps the stack running, with a warning.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.models.registry import ModelBundle, StubTokenizer

logger = init_logger(__name__)

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors.

    Raises ``ValueError`` on a dtype other than F32, F16, BF16 and I64, or
    on a header whose offsets do not fit the data or the shape.
    """
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        shape = info["shape"]
        start, end = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= start <= end <= len(data) \
                or end - start != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name} {info['dtype']}{shape} at "
                             f"bytes [{start}, {end}) of {len(data)}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # copied out of the buffer: a tensor's offset need not be aligned
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start,
                               offset=start).clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def _load_safetensors_dir(component_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a component directory (JAX loader.py:28-48): all
    its ``*.safetensors`` files, so a sharded checkpoint
    (``model-0000k-of-0000n``) merges; the non-variant set is preferred
    over ``.fp16.``/``.bf16.`` variants when both are there."""
    files = sorted(f for f in os.listdir(component_dir)
                   if f.endswith(".safetensors"))
    main = [f for f in files if ".fp16." not in f and ".bf16." not in f]
    if main:
        files = main
    if not files:
        raise FileNotFoundError(f"no safetensors in {component_dir}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(os.path.join(component_dir, f)))
    return sd


def _load_tokenizer(snapshot: str, subdir: str, fallback_vocab: int,
                    t5: bool = False):
    """The snapshot's tokenizer through ``transformers`` where ``subdir``
    holds one (its ``tokenizer_config.json``), or the hash stub (JAX
    loader.py:84-101; the T5 stub: 256 ids, no BOS, EOS 1, pad 0)."""
    tok_dir = os.path.join(snapshot, subdir)
    if not os.path.isfile(os.path.join(tok_dir, "tokenizer_config.json")):
        logger.warning("snapshot %s has no %s/ — falling back to the "
                       "HASH STUB tokenizer (outputs will be garbage "
                       "with real weights)", snapshot, subdir)
    else:
        try:
            import transformers
        except ImportError:
            logger.warning("transformers is not installed — falling back "
                           "to the HASH STUB tokenizer for %s (outputs will "
                           "be garbage with real weights)", tok_dir)
        else:
            return transformers.AutoTokenizer.from_pretrained(tok_dir)
    if t5:
        return StubTokenizer(fallback_vocab, model_max_length=256, bos=None,
                             eos=1, pad=0)
    return StubTokenizer(fallback_vocab)


def load_bundle(family: str, snapshot: Optional[str] = None,
                tiny: bool = False, dtype: torch.dtype = torch.bfloat16,
                seed: int = 0, device: torch.device | str = "cuda",
                vae_dtype: str = "auto") -> ModelBundle:
    """A ``ModelBundle`` on ``device``: seeded random weights when
    ``snapshot`` is None, else the snapshot's weights and tokenizers."""
    bundle = ModelBundle(family, tiny=tiny, dtype=dtype, device=device,
                         vae_dtype=vae_dtype)
    if snapshot is None:
        bundle.init_random(seed=seed)
        return bundle
    with open(os.path.join(snapshot, "model_index.json")) as f:
        index = json.load(f)
    logger.info("loading %s from %s (%s)", family, snapshot,
                index.get("_class_name"))
    # snapshot directories tokenizer/, tokenizer_2/, tokenizer_3/ go with
    # text_encoder/, text_encoder_2/, text_encoder_3/ (T5 in SD3)
    for i, role in enumerate(bundle.spec.text_encoders):
        key = "tokenizer" if i == 0 else f"tokenizer_{i + 1}"
        te = "text_encoder" if i == 0 else f"text_encoder_{i + 1}"
        bundle.tokenizers[key] = _load_tokenizer(
            snapshot, key, bundle.models[te].cfg.vocab_size, t5=role == "t5")
    # one component's tensors in host memory at a time
    for name in bundle.models:
        bundle.load_component(
            name, _load_safetensors_dir(os.path.join(snapshot, name)))
    return bundle
