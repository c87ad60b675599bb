"""Per-dataset palettes and class names for the label-scarce task (a copy
of the JAX package's ``tasks/scarce/palettes.py``).

Constant tables transcribed from the reference
(scarce_segmentation/segmentation/data_util.py:100-298): flat RGB
triplets per class (ffhq stored as floats there and scaled by 255 at
import, reproduced pre-scaled; ade_bedroom_30 is the first 30 entries
of the 50-class table, data_util.py:141-143).
"""

import numpy as np

FFHQ_34_PALETTE = [
    255, 255, 255, 112, 130, 107, 218, 243, 81, 61, 119, 252, 215, 237, 192,
    95, 201, 83, 4, 126, 96, 190, 3, 144, 41, 61, 186, 5, 111, 104, 149, 226,
    156, 203, 232, 247, 173, 159, 218, 254, 119, 98, 136, 210, 69, 44, 92,
    212, 135, 170, 125, 54, 88, 120, 174, 31, 37, 98, 118, 25, 58, 10, 77,
    146, 139, 250, 33, 245, 19, 72, 47, 66, 248, 240, 169, 99, 113, 164, 221,
    100, 24, 155, 247, 6, 93, 170, 79, 164, 186, 243, 157, 27, 230, 86, 126,
    185, 42, 235, 167, 240, 171, 157,
]

FFHQ_34_CLASSES = [
    'background', 'head', 'head***cheek', 'head***chin', 'head***ear',
    'head***ear***helix', 'head***ear***lobule', 'head***eye***bottom lid',
    'head***eye***eyelashes', 'head***eye***iris', 'head***eye***pupil',
    'head***eye***sclera', 'head***eye***tear duct', 'head***eye***top lid',
    'head***eyebrow', 'head***forehead', 'head***frown', 'head***hair',
    'head***hair***sideburns', 'head***jaw', 'head***moustache',
    'head***mouth***inferior lip', 'head***mouth***oral commissure',
    'head***mouth***superior lip', 'head***mouth***teeth', 'head***neck',
    'head***nose', 'head***nose***ala of nose', 'head***nose***bridge',
    'head***nose***nose tip', 'head***nose***nostril', 'head***philtrum',
    'head***temple', 'head***wrinkles',
]

BEDROOM_28_PALETTE = [
    255, 255, 255, 238, 229, 102, 255, 72, 69, 124, 99, 34, 193, 127, 15,
    106, 177, 21, 248, 213, 43, 252, 155, 83, 220, 147, 77, 99, 83, 3, 116,
    116, 138, 63, 182, 24, 200, 226, 37, 225, 184, 161, 233, 5, 219, 142,
    172, 248, 153, 112, 146, 38, 112, 254, 229, 30, 141, 99, 205, 255, 74,
    59, 83, 186, 9, 0, 107, 121, 0, 0, 194, 160, 255, 170, 146, 255, 144,
    201, 185, 3, 170, 221, 239, 255, 0, 0, 53,
]

BEDROOM_28_CLASSES = [
    'background', 'bed', 'bed***footboard', 'bed***headboard',
    'bed***side rail', 'carpet', 'ceiling', 'chandelier / ceiling fan blade',
    'curtain', 'cushion', 'floor', 'table/nightstand/dresser',
    'table/nightstand/dresser***top', 'picture / mirrow', 'pillow',
    'lamp***column', 'lamp***shade', 'wall', 'window', 'curtain rod',
    'window***frame', 'chair', 'picture / mirror***frame', 'plinth',
    'door / door frame', 'pouf', 'wardrobe', 'plant', 'table staff',
]

CAT_15_PALETTE = [
    255, 255, 255, 190, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35,
    102, 102, 156, 152, 251, 152, 119, 11, 32, 244, 35, 232, 220, 20, 60, 52,
    83, 84, 194, 87, 125, 143, 176, 255, 31, 102, 211, 104, 131, 101,
]

CAT_15_CLASSES = [
    'background', 'back', 'belly', 'chest', 'leg', 'paw', 'head', 'ear',
    'eye', 'mouth', 'tongue', 'nose', 'tail', 'whiskers', 'neck',
]

HORSE_21_PALETTE = [
    255, 255, 255, 255, 74, 70, 0, 137, 65, 0, 111, 166, 163, 0, 89, 255,
    219, 229, 122, 73, 0, 0, 0, 166, 99, 255, 172, 183, 151, 98, 0, 77, 67,
    143, 176, 255, 241, 38, 110, 27, 210, 105, 128, 150, 147, 228, 230, 158,
    160, 136, 106, 79, 198, 1, 59, 93, 255, 115, 214, 209, 255, 47, 128,
]

HORSE_21_CLASSES = [
    'background', 'person', 'back', 'barrel', 'bridle', 'chest', 'ear',
    'eye', 'forelock', 'head', 'hoof', 'leg', 'mane', 'muzzle', 'neck',
    'nostril', 'tail', 'thigh', 'saddle', 'shoulder', 'leg protection',
]

ADE_BEDROOM_30_PALETTE = [
    240, 156, 206, 69, 88, 93, 240, 49, 184, 27, 107, 126, 50, 82, 241, 54,
    250, 147, 156, 213, 3, 176, 108, 79, 251, 150, 149, 66, 51, 34, 210, 97,
    53, 30, 53, 102, 232, 164, 118, 204, 150, 17, 101, 86, 178, 249, 20, 213,
    54, 35, 82, 157, 68, 216, 58, 161, 73, 174, 67, 67, 193, 181, 78, 169,
    60, 178, 220, 204, 166, 4, 127, 85, 245, 106, 216, 222, 172, 168, 84,
    148, 105, 137, 220, 89, 68, 252, 126, 29, 193, 187,
]

ADE_BEDROOM_30_CLASSES = [
    'wall', 'bed', 'floor', 'table', 'lamp', 'ceiling', 'painting',
    'windowpane', 'pillow', 'curtain', 'cushion', 'door', 'chair', 'cabinet',
    'chest', 'mirror', 'rug', 'armchair', 'book', 'sconce', 'plant',
    'wardrobe', 'clock', 'light', 'flower', 'vase', 'fan', 'box', 'shelf',
    'television',
]

CELEBA_19_PALETTE = [
    255, 255, 255, 238, 229, 102, 250, 150, 50, 124, 99, 34, 193, 127, 15,
    225, 96, 18, 220, 147, 77, 99, 83, 3, 116, 116, 138, 200, 226, 37, 225,
    184, 161, 142, 172, 248, 153, 112, 146, 38, 112, 254, 229, 30, 141, 52,
    83, 84, 194, 87, 125, 248, 213, 42, 31, 102, 211,
]

CELEBA_19_CLASSES = [
    'background', 'cloth', 'ear_r', 'eye_g', 'hair', 'hat', 'l_brow',
    'l_ear', 'l_eye', 'l_lip', 'mouth', 'neck', 'neck_l', 'nose', 'r_brow',
    'r_ear', 'r_eye', 'skin', 'u_lip',
]

PALETTES = {
    'ffhq_34': np.asarray(FFHQ_34_PALETTE, np.uint8).reshape(-1, 3),
    'bedroom_28': np.asarray(BEDROOM_28_PALETTE, np.uint8).reshape(-1, 3),
    'cat_15': np.asarray(CAT_15_PALETTE, np.uint8).reshape(-1, 3),
    'horse_21': np.asarray(HORSE_21_PALETTE, np.uint8).reshape(-1, 3),
    'ade_bedroom_30': np.asarray(ADE_BEDROOM_30_PALETTE, np.uint8).reshape(-1, 3),
    'celeba_19': np.asarray(CELEBA_19_PALETTE, np.uint8).reshape(-1, 3),
}

CLASS_NAMES = {
    'ffhq_34': FFHQ_34_CLASSES,
    'bedroom_28': BEDROOM_28_CLASSES,
    'cat_15': CAT_15_CLASSES,
    'horse_21': HORSE_21_CLASSES,
    'ade_bedroom_30': ADE_BEDROOM_30_CLASSES,
    'celeba_19': CELEBA_19_CLASSES,
}
