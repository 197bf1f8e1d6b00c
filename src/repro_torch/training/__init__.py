"""Training on one device, the port of src/repro/training/: AdamW with the
reference's options (`optim`), gradient accumulation (`accumulate`), int8
error-feedback compression (`compression`, with the int8 all-reduce
`compressed_psum` over a process group) and checkpoints (`checkpoint`,
restorable onto a mesh).

Gradients, optimizer states and error states live in the reference's
parameter tree, stacked over stages as the reference stacks them
(`models.transformer.reference_tree`), so that weight decay, the factored
second moment and the int8 scales see the reference's leaves, and a
checkpoint written by one package restores in the other.
"""
