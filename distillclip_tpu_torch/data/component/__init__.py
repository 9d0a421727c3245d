"""Dataset components, found by name by ``data.datamodule.MainDataModule``:
``synthetic``, and the corpora of the final configs, ``ms_coco`` (stage 3),
``combine_image_dataset`` (stage 1), ``combine_text_dataset`` (stage 2) and
``text_image_webdataset`` (tar shards); ``utils`` holds the teacher's
pre-encoding that their ``prepare`` hooks run.
"""
