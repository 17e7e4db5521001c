"""Scene lists (reference datasets/__init__.py:1-42), the port's copy of
cednerf_tpu/datasets/__init__.py's; module names mirror cednerf_tpu."""

DNERF_SYNTHETIC_SCENES = [
    "bouncingballs",
    "hellwarrior",
    "hook",
    "jumpingjacks",
    "lego",
    "mutant",
    "standup",
    "trex",
]

DYNERF_SCENES = [
    "coffee_martini",
    "cook_spinach",
    "cut_roasted_beef",
    "flame_salmon_1",
    "flame_salmon_2",
    "flame_salmon_3",
    "flame_salmon_4",
    "flame_steak",
    "sear_steak",
]

HYPERNERF_SCENES = [
    "interp_aleks-teapot",
    "interp_chickchicken",
    "interp_cut-lemon",
    "interp_hand",
    "interp_slice-banana",
    "interp_torchocolate",
    "misc_americano",
    "misc_cross-hands",
    "misc_espresso",
    "misc_keyboard",
    "misc_oven-mitts",
    "misc_split-cookie",
    "misc_tamping",
    "vrig_3dprinter",
    "vrig_broom",
    "vrig_chicken",
    "vrig_peel-banana",
]
