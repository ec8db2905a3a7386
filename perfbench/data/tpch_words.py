"""Frozen copy of presto1_tpu_torch/tpch/words.py,
kept here so that the benchmark's data does not move with the program.

TPC-H specification word lists (TPC-H standard spec §4.2.2 appendix).

These are the public TPC-H benchmark constants (also used by the reference's
external io.trino.tpch dbgen library referenced from
plugin/trino-tpch/.../TpchRecordSetProvider.java:25).
"""

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

CONTAINERS_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINERS_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

# (name, regionkey) in nationkey order 0..24
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# --- text-grammar word lists (spec §4.2.2.13) ---

NOUNS = (
    "foxes ideas theodolites pinto_beans instructions dependencies excuses "
    "platelets asymptotes courts dolphins multipliers sauternes warthogs "
    "frets dinos attainments somas Tiresias patterns forges braids "
    "hockey_players frays warhorses dugouts notornis epitaphs pearls tithes "
    "waters orbits gifts sheaves depths sentiments decoys realms pains "
    "grouches escapades packages accounts deposits requests foxes"
).split()
NOUNS = [w.replace("_", " ") for w in NOUNS]

VERBS = (
    "sleep haggle laugh nag detect dazzle snooze doze unwind kindle play "
    "hang believe doubt integrate thrash use boost affix print x-ray breach "
    "eat grow impress mold poach serve run dye sublate wake cajole engage "
    "maintain promise befriend solve"
).split()

ADJECTIVES = (
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close "
    "dogged daring brave stealthy permanent enticing idle busy regular "
    "final ironic even bold silent special pending express unusual"
).split()

ADVERBS = (
    "sometimes always never furiously slyly carefully blithely quickly "
    "fluffily slowly quietly ruthlessly thinly closely doggedly daringly "
    "bravely stealthily permanently enticingly idly busily regularly "
    "finally ironically evenly boldly silently"
).split()

PREPOSITIONS = (
    "about above according_to across after against along alongside_of among "
    "around at atop before behind beneath beside besides between beyond by "
    "despite during except for from in_place_of inside instead_of into near "
    "of on outside over past since through throughout to toward under until "
    "up upon without with within"
).split()
PREPOSITIONS = [w.replace("_", " ") for w in PREPOSITIONS]

AUXILIARIES = [
    "do", "may", "might", "shall", "will", "would", "can", "could", "should",
    "ought to", "must", "will have to", "shall have to", "could have to",
    "should have to", "must have to", "need to", "try to",
]

TERMINATORS = [".", ";", ":", "?", "!", "--"]
