"""Feature extractors of the port (vilco_tpu/extractors/): CLIP image
features of video frames (`clip_image`), CLIP text and RoBERTa token
features of queries (`clip_text`), their towers (`encoders`), weights
(`weights`) and tokenizers (`tokenizers`)."""
