"""Operator CLI tools of the port (counterparts of ceph_tpu/tools).

Each tool is an argparse ``main(argv, out) -> int`` so tests drive it in
process and ``python -m ceph_tpu_torch.tools.<tool>`` drives it from a
shell.
"""
