"""Applications of the port: the DeepLab masking tool and the sky-swap
video workflow; Gram-matrix NST (``slow_nst``); the weight-ladder apps
(``style_all_weights``, ``style_video_pipeline``, ``multi_model_video``,
``style_morph``); the magenta self-style apps (``selfstyle_blob``,
``batch_selfstyle``, ``generate_magenta_self_style``); the video apps
(``run_videos``, ``run_styles``, ``drive_videos``: env contracts, the job
queue across hosts); the presets apps (``generate_multimodel_presets``,
``generate_preset_samples``, ``generate_video_samples``,
``generate_morph_samples``); the morph apps (``morph``, ``morph_faces``,
``morph_v2``, ``morph_slideshow``, ``gen_pytorch_only_videos``); the
showcase and mask apps (``style_showcase``, ``style_mask``,
``generate_mask_samples``, ``generate_style_selfstyle``) and the text
overlays (``cryptic_text``)."""
