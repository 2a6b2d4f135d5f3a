"""Feature files from image folders (JAX ``cli/extract_features.py``): ``python
-m fast_image_recognition_tpu_torch.scripts.extract_features dataset_root
output [--device cpu]``; ``main(argv)`` returns the count."""

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_root", help="directory of <class>/<image> dirs")
    parser.add_argument("output", help="output feature file path")
    for name, default in (("variant", "b0"), ("batch-size", 64), ("data-parallel", 0)):  # data-parallel: devices
        parser.add_argument("--" + name, type=type(default), default=default)
    parser.add_argument("--checkpoint", default=None, help="flax msgpack checkpoint")
    parser.add_argument("--device", default=device, help="default the card; 'cpu' runs the plain path")
    args = parser.parse_args(argv)

    from ..models.extractor import extract_dataset_to_file
    from ..parallel.mesh import make_mesh
    from ..utils.checkpoint import load_variables

    variables = load_variables(args.checkpoint) if args.checkpoint else None
    mesh = None
    if args.data_parallel:  # a device may repeat: --device cpu gives N entries of the CPU
        mesh = make_mesh(data=args.data_parallel, devices=None if args.device is None else
                [args.device] * args.data_parallel)
    n = extract_dataset_to_file(args.dataset_root, args.output, variant=args.variant, variables=variables,
            batch_size=args.batch_size, mesh=mesh, device=args.device)
    print(f"extracted {n} images -> {args.output}")
    return n


if __name__ == "__main__":
    main()
