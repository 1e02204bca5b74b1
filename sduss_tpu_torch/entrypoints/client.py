"""Minimal HTTP client (counterpart of sduss_tpu/entrypoints/client.py),
on ``urllib.request``.

    python -m sduss_tpu_torch.entrypoints.client --url http://localhost:8000 \\
        --resolution 1024 --steps 30 --save out.png
"""

from __future__ import annotations

import argparse
import base64
import json
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np


def post_json(url: str, payload: dict, timeout: float = 3600.0) -> dict:
    """POST ``payload`` as JSON; the decoded JSON answer, also for an
    error status (whose body carries {"error": ...})."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return json.loads(e.read())


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 image of a PNG as the server writes it (8-bit
    RGB, no interlace, filter 0 on every scanline); other PNGs raise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + chunk) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat += chunk
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG: {hdr}")
    w, h = hdr[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("a scanline uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def generate(url: str, prompt: str, resolution: int, steps: int,
             want_image: bool = False) -> dict:
    return post_json(f"{url}/generate", {
        "prompt": prompt, "resolution": resolution,
        "num_inference_steps": steps, "return_image": want_image,
    })


def main(argv=None) -> None:
    p = argparse.ArgumentParser("sduss_tpu_torch client")
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--prompt", default="a photograph of an astronaut riding a horse")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--save", default=None, help="write the PNG here")
    args = p.parse_args(argv)
    out = generate(args.url, args.prompt, args.resolution, args.steps,
                   want_image=args.save is not None)
    if args.save and out.get("image_base64"):
        with open(args.save, "wb") as f:
            f.write(base64.b64decode(out.pop("image_base64")))
        out["saved_to"] = args.save
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
