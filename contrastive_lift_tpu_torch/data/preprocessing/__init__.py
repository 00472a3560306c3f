"""Raw captures to the common scene layout: the port's copy of
``contrastive_lift_tpu/data/preprocessing``, without PIL, JAX or cv2.

Each script runs as ``python -m
contrastive_lift_tpu_torch.data.preprocessing.<name>`` with the flags of
its JAX twin: ``scannet`` (a ScanNet ``.sens`` stream), ``m2f`` (raw
Mask2Former panoptic dumps), ``generic`` (frames + poses), ``replica``,
``itw`` (nerfstudio ``transforms.json``), ``hypersim`` (HDF5, needs
h5py), ``bboxes`` (3D box annotations) and ``exports`` (other papers'
layouts). They are host code: numpy, ``zlib`` and the port's codecs
(``utils/jpeg.py``, ``utils/png.py``, ``utils/image.py``).
"""
