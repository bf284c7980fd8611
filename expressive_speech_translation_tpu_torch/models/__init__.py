"""Model functions over parameter dicts of torch tensors."""
