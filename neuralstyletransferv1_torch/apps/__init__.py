"""Applications of the port: the DeepLab masking tool and the sky-swap
video workflow."""
