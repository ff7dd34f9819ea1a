"""The flex tier's named-index layer: indices, tensors and factorizations."""
