"""The benchmark's own counts of the operations and bytes a kernel group
needs, and the published peaks of the card (NVIDIA H100 SXM, dense, at
its full power limit of 700 W): a roofline share is the least time these
counts allow over the time the group's kernels took on the device."""
