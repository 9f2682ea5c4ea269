"""The plain PyTorch reference of UFM that decides ``correct``; it imports nothing of the system under test."""
