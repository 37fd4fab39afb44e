"""Offline person-mask extraction, the port's command line (the twin of
``scripts/extract_masks.py``; reference core/process_mask.py __main__,
:230-303): raw frames -> binary person masks, no user code.  The model
backends run on the GPU unless ``--device cpu`` asks for the CPU.

Examples:
  # background subtraction (static camera, no model needed)
  python -m anerf_torch.extract_masks --images 'frames/*.png' \
      --backend background --bkgd clean_plate.png --out masks/

  # TorchScript DeepLab (export torchvision deeplabv3 offline)
  python -m anerf_torch.extract_masks --images 'frames/*.png' \
      --backend torchscript --model deeplabv3.ts --out masks/

  # HuggingFace SegFormer from a local dir (ADE20K person=12), on the CPU
  python -m anerf_torch.extract_masks --video clip.mp4 \
      --backend transformers --model ./segformer_dir \
      --person_label 12 --device cpu --out masks/

  # SPIN-bbox-cropped variant (reference process_bbox_masks)
  python -m anerf_torch.extract_masks --images 'frames/*.png' \
      --backend torchscript --model deeplabv3.ts \
      --bboxes spin_bboxes.npy --out masks/
"""
import argparse
import glob
import os

import numpy as np

from .data.mask_extract import (PERSON_LABEL, extract_bbox_masks,
                                extract_masks, masks_from_background,
                                save_mask_video, torchscript_seg_fn,
                                transformers_seg_fn)


def load_frames(args):
    import imageio.v2 as imageio
    if args.video:
        reader = imageio.get_reader(args.video)
        frames = [f[..., :3] for f in reader]
        names = [f'{i:05d}.png' for i in range(len(frames))]
        return np.stack(frames).astype(np.uint8), names
    paths = sorted(glob.glob(args.images))
    assert paths, f'no frames match {args.images}'
    frames = [imageio.imread(p)[..., :3] for p in paths]
    names = [os.path.splitext(os.path.basename(p))[0] + '.png'
             for p in paths]
    return np.stack(frames).astype(np.uint8), names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--images', type=str, default=None,
                   help='glob of frame images')
    p.add_argument('--video', type=str, default=None,
                   help='video file instead of frames')
    p.add_argument('--backend', type=str, default='background',
                   choices=['background', 'torchscript', 'transformers'])
    p.add_argument('--model', type=str, default=None,
                   help='TorchScript file / local transformers model dir')
    p.add_argument('--bkgd', type=str, default=None,
                   help='clean-plate image for the background backend')
    p.add_argument('--bboxes', type=str, default=None,
                   help='.npy of (N, 3) SPIN [cx, cy, box_len] crops; '
                        'enables the bbox-cropped variant')
    p.add_argument('--person_label', type=int, default=PERSON_LABEL,
                   help="model's person class id (PASCAL 15, ADE20K 12)")
    p.add_argument('--input_size', type=int, default=513,
                   help='segment at longer-side=input_size (0: native)')
    p.add_argument('--dilate', type=int, default=1,
                   help='3x3 dilation iterations on the mask boundary')
    p.add_argument('--out', type=str, required=True)
    p.add_argument('--save_video', action='store_true',
                   help='also export a mask-overlay inspection video')
    p.add_argument('--device', type=str, default=None,
                   help="the model backends' device (default: the GPU; "
                        "'cpu' runs them on the CPU)")
    args = p.parse_args(argv)

    import imageio.v2 as imageio
    frames, names = load_frames(args)
    os.makedirs(args.out, exist_ok=True)

    if args.backend == 'background':
        assert args.bkgd, '--backend background needs --bkgd'
        bkgd = imageio.imread(args.bkgd)[..., :3].astype(np.uint8)
        masks = masks_from_background(frames, bkgd)
    else:
        assert args.model, f'--backend {args.backend} needs --model'
        seg_fn = (torchscript_seg_fn(args.model, device=args.device)
                  if args.backend == 'torchscript'
                  else transformers_seg_fn(model_dir=args.model,
                                           device=args.device))
        size = args.input_size if args.input_size > 0 else None
        if args.bboxes:
            bboxes = np.load(args.bboxes)
            masks = extract_bbox_masks(frames, bboxes, seg_fn,
                                       person_label=args.person_label,
                                       input_size=size, dilate=args.dilate)
        else:
            masks = extract_masks(frames, seg_fn,
                                  person_label=args.person_label,
                                  input_size=size, dilate=args.dilate)

    for name, m in zip(names, masks):
        imageio.imwrite(os.path.join(args.out, name),
                        (m[..., 0] * 255).astype(np.uint8))
    if args.save_video:
        save_mask_video(os.path.join(args.out, 'masks.mp4'), masks,
                        imgs=frames)
    print(f'wrote {len(masks)} masks to {args.out}')
    return masks


if __name__ == '__main__':
    main()
