"""The clinical engine: CT/CBCT -> bone mesh -> osteotomy plan (port of
`omfs4d.clinical`), with the volume and mesh work on the device."""

from omfs4d_torch.clinical.loader import (  # noqa: F401
    TOOTHFAIRY_LABELS,
    UPPER_TEETH_LABELS,
    LOWER_TEETH_LABELS,
    ALL_TEETH_LABELS,
    dicom_to_bone_mesh,
    hu_volume_to_bone_mesh,
    load_dicom_volume,
    nifti_image_to_bone_mesh,
    nifti_label_to_bone_mesh,
    nifti_label_to_separate_meshes,
)
from omfs4d_torch.clinical.surgical import SurgicalCutter  # noqa: F401
from omfs4d_torch.clinical.segmentation import segment_volume, register_segmenter  # noqa: F401
