"""Host input-pipeline throughput of the port.

Measures, on a fabricated JPEG corpus (``tools/fabricate_images.py``: real
JPEG decode cost, no download):

* items/s through ``CombineImageDataset`` -> ``DataLoader`` per loader thread
  count, in the three wire formats of the final image fits: uint8 with the
  normalisation on the device, host-normalised fp32, and uint8 without
  augmentation (the cached-teacher configs' pixel path).  Each batch is
  carried to the run's device and normalised there as the trainer does
  (``serving.inputs.prepare_inputs``), so the rate is what a step can be fed;
* captions/s of the BPE tokenizer, the native merge loop and pure Python, on a
  fabricated merges table (a cost proxy; no CLIP vocabulary is in the
  repository).

The image path is what sets the pace of the final configs' image fits
(``PERF.md``), so the question it answers is how many host threads a step
rate needs: a bare step's pairs/s over the rate of one thread.

    python -m distillclip_tpu_torch.tools.input_bench
    python -m distillclip_tpu_torch.tools.input_bench --threads 1 4 --n 256 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

VARIANTS = (
    ("uint8_augment", dict(device_normalize=True, augment_train=True)),
    ("f32_augment", dict(device_normalize=False, augment_train=True)),
    ("uint8_noaugment", dict(device_normalize=True, augment_train=False)),
)


def bench_images(corpus: str, n: int, threads_list, image_size: int = 224,
                 device: str = "cuda", batch_size: int = 64) -> dict:
    """items/s per variant and thread count: the first batch (thread start,
    the decoder's load) is not timed; the rest up to ``n`` items are, each
    carried to ``device`` and normalised there."""
    import torch

    from distillclip_tpu_torch.data.component.combine_image_dataset import CombineImageDataset
    from distillclip_tpu_torch.data.loader import DataLoader
    from distillclip_tpu_torch.serving.inputs import prepare_inputs

    def consume(batch):
        x = torch.as_tensor(batch["inputs"])
        if torch.device(device).type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        return prepare_inputs(x.to(device), torch.bfloat16)

    out = {}
    for name, kw in VARIANTS:
        ds = CombineImageDataset(combine_dataset_path=os.path.join(corpus, "combined"),
                                 train=True, image_use=["coco", "imagenet"],
                                 image_size=image_size, use_native_decode=True, **kw)
        n_eff = min(n, len(ds))
        per_threads = {}
        for t in threads_list:
            loader = DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False,
                                num_threads=t)
            it = iter(loader)
            first = next(it)
            consume(first)
            skipped = seen = len(first["inputs"])
            last = None
            t0 = time.perf_counter()
            for batch in it:
                last = consume(batch)
                seen += len(batch["inputs"])
                if seen >= n_eff:
                    break
            if last is not None and last.is_cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_threads[str(t)] = (seen - skipped) / dt if seen > skipped else None
        out[name] = per_threads
    return out


def _fabricated_merges(path: str, n: int = 2000) -> str:
    """A synthetic BPE merges table (adjacent-letter merges, so that the merge
    loop does real work): a cost proxy, not the CLIP vocabulary."""
    import gzip
    import itertools
    import string

    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = ["#version: fabricated"]
    for a, b in itertools.product(string.ascii_lowercase, repeat=2):
        lines.append(f"{a} {b}")
        lines.append(f"{a} {b}</w>")
        if len(lines) > n:
            break
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def bench_tokenizer(n: int = 20000, cache_dir: str = ".cache") -> dict:
    """captions/s: the native merge loop against pure Python, batch tokenize."""
    from distillclip_tpu_torch.data.tokenizer import SimpleTokenizer

    bpe = _fabricated_merges(os.path.join(cache_dir, "input_bench_merges.txt.gz"))
    captions = [f"a photo of number {i} with a {w}"
                for i, w in zip(range(n), ["dog", "cat", "bus", "tree", "boat"] * (n // 5 + 1))]
    out = {}
    for name, native in (("native", True), ("python", False)):
        try:
            tok = SimpleTokenizer(bpe, merge_limit=None, use_native=native)
        except Exception as e:                  # the native library or `regex` missing
            out[name] = f"unavailable: {type(e).__name__}"
            continue
        if native and tok._native is None:
            out[name] = "unavailable: native BPE library did not load"
            continue
        tok.tokenize(captions[:64], context_length=77)  # warm
        t0 = time.perf_counter()
        tok.tokenize(captions, context_length=77)
        out[name] = n / (time.perf_counter() - t0)
    return out


def run(corpus: str = None, n: int = 512, threads_list=(1, 2, 4), image_size: int = 224,
        n_captions: int = 20000, device: str = "cuda", cache_dir: str = ".cache",
        batch_size: int = 64) -> dict:
    from distillclip_tpu_torch.tools.fabricate_images import fabricate

    n_fab = max(n, 512)
    if corpus is None:
        # keyed by geometry: a small quick-run corpus is never re-measured as
        # the 224 px decode cost
        corpus = os.path.join(cache_dir, f"input_bench_corpus_{image_size}px_{n_fab}")
    if not os.path.exists(os.path.join(corpus, "combined")):
        fabricate(corpus, n_train=n_fab, n_val=8, size=image_size)
    images = bench_images(corpus, n, list(threads_list), image_size, device, batch_size)
    tokens = bench_tokenizer(n_captions, cache_dir)
    return {"images_per_s": images, "captions_per_s": tokens, "device": device,
            "corpus": corpus, "cpu_count": os.cpu_count()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default=None,
                    help="a fabricated corpus (its combined/ directory); made if absent")
    ap.add_argument("--n", type=int, default=512, help="items timed per thread count")
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--captions", type=int, default=20000)
    ap.add_argument("--device", default="cuda", help="where batches are normalised")
    args = ap.parse_args(argv)
    res = run(args.corpus, args.n, args.threads, args.image_size, args.captions, args.device)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
