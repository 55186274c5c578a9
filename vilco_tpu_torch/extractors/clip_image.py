"""CLIP image features of video frames (vilco_tpu/extractors/
clip_image.py): frames in batches through the CLIP vision tower
(extractors/encoders.py::CLIPVisionTower, K1 in its attention on the
card), pooled features written as a (T, D) f32 array in the .npy format
the MQ loader reads.

  python -m vilco_tpu_torch.extractors.clip_image --frames-npy f.npy \\
      --out feats.npy [--model-path DIR] [--device cpu]

`--model-path` is a local HF CLIP directory with its torch files
(config.json and pytorch_model.bin or model.safetensors;
extractors/weights.py); without one, JAX's random-init tower (256 wide,
2 layers, 4 heads, MLP 512, patch 32) from seed 0 of torch's generator,
for pipeline runs. Frames go in unnormalised (T, H, W, 3), as JAX's
extractor passes them. The tower runs on the card (`--device`), which
raises where there is none.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.extractors.encoders import CLIPVisionCfg, CLIPVisionTower


class ClipImageExtractor:
    def __init__(self, model_path: Optional[str] = None,
                 image_size: int = 224, batch_size: int = 64,
                 device="cuda"):
        self.batch_size = batch_size
        self.image_size = image_size
        self.device = device_of(device)
        if model_path:
            from vilco_tpu_torch.extractors.weights import load_hf_dir

            self.model = load_hf_dir(model_path, "clip_vision", self.device)
        else:
            cfg = CLIPVisionCfg(
                hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=4, image_size=image_size, patch_size=32)
            self.model = CLIPVisionTower(cfg, device=self.device)
        self.model.eval()

    @torch.no_grad()
    def extract_frames(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) float frames -> (T, D) pooled features."""
        out = []
        for s in range(0, len(frames), self.batch_size):
            chunk = np.asarray(frames[s:s + self.batch_size], np.float32)
            px = torch.from_numpy(chunk).to(self.device).permute(0, 3, 1, 2)
            out.append(self.model(px.contiguous())["pooler_output"].cpu())
        return torch.cat(out).numpy().astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames-npy", required=True,
                   help="(T, H, W, 3) frame array per clip")
    p.add_argument("--out", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)
    frames = np.load(args.frames_npy)
    ex = ClipImageExtractor(args.model_path, image_size=frames.shape[1],
                            device=args.device)
    np.save(args.out, ex.extract_frames(frames))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
