"""Applications of the port: the DeepLab masking tool and the sky-swap
video workflow; Gram-matrix NST (``slow_nst``); the weight-ladder apps
(``style_all_weights``, ``style_video_pipeline``, ``multi_model_video``,
``style_morph``); the magenta self-style apps (``selfstyle_blob``,
``batch_selfstyle``, ``generate_magenta_self_style``)."""
