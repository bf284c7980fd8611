"""The plain reference that decides ``correct``: frozen copies of the port's
model code in plain PyTorch (no kernel, one device, no int8, no shards),
run in float32 with TF32 off on weights it draws again from the
configuration's seeds. It imports nothing of the port."""
