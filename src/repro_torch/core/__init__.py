"""ERCache core: cache tables, write/touch rings, admission budget and the
single-model serving tier, as PyTorch functions on tensors."""
