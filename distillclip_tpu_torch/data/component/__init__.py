"""Dataset components, found by name by ``data.datamodule.MainDataModule``.

Ported: ``synthetic``.  The corpora (``ms_coco``, ``combine_image_dataset``,
``combine_text_dataset``, ``text_image_webdataset``) wait for ROADMAP queue 1:
real datasets and multi-GPU.
"""
