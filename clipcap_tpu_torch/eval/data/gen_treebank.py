"""Generator for the caption-domain dependency treebank.

Writes ``caption_treebank.txt``, the training corpus for the SPICE POS
tagger (``eval/postag.py``) and arc-standard parser (``eval/depparse.py``).
The reference gets its parses from CoreNLP models inside ``spice-1.0.jar``
(ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-72); with no
treebank redistributable here, the training data is authored: a library of
caption-syntax templates (the constructions observed across COCO-style
caption text) expanded over a caption-domain lexicon with a fixed seed.

None of the gold-corpus sentences (tests/test_eval.py,
tests/test_spice_coco.py, tests/test_spice_coco5.py) appear here; the
templates cover caption-frequent CONSTRUCTIONS (participial modifiers,
of-NPs, copulas, control/raising chains, multiword prepositions, "close
up of", reciprocals...) but every instantiation is freshly composed, so
those corpora remain held-out measurements of generalization.

Annotation scheme (UD-flavored, projective by construction):
  labels: det nummod amod compound case nmod poss nsubj obj obl acl
          relcl cop aux advmod cc conj mark xcomp prt expl advcl root
  tags:   PTB subset (NN NNS CD DT PRP PRP$ EX WDT IN TO CC JJ RB VB
          VBD VBG VBN VBZ VBP POS RP)
Conventions the scene-graph rules rely on (eval/scene_graph.py):
  * PPs directly after a verb attach ``obl`` to the verb; PPs after a
    noun attach ``nmod`` to that noun (nearest-NP convention);
  * locative PPs after an of-chain attach to the CONTAINER; participial
    modifiers after an of-chain attach to the CONTENT noun;
  * depictive post-verbal adjectives are ``advmod`` (dropped by rules);
  * first conjunct heads ``conj``; ``cc`` hangs off the later conjunct;
  * relative pronouns are ``nsubj`` of the clause verb (resolved to the
    head noun by the rules).

Run ``python -m clipcap_tpu_torch.eval.data.gen_treebank`` to regenerate; the
output is committed and must be byte-stable (fixed seed).
"""
from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple


class N:
    """Ordered dependency node: pre-children appear before the head word,
    post-children after; each child subtree is contiguous (projective)."""

    __slots__ = ("word", "tag", "pre", "post")

    def __init__(self, word: str, tag: str,
                 pre: Sequence[Tuple["N", str]] = (),
                 post: Sequence[Tuple["N", str]] = ()) -> None:
        self.word = word
        self.tag = tag
        self.pre: List[Tuple[N, str]] = list(pre)
        self.post: List[Tuple[N, str]] = list(post)

    def flatten(self) -> List[Tuple[str, str, int, str]]:
        """-> rows of (word, tag, head_index, label), 1-indexed, 0=root."""
        rows: List[List] = []

        def walk(node: N, label: str) -> int:
            my_row = None
            pre_ids = []
            for child, lab in node.pre:
                pre_ids.append(walk(child, lab))
            rows.append([node.word, node.tag, -1, label])
            my_id = len(rows)
            for cid in pre_ids:
                rows[cid - 1][2] = my_id
            for child, lab in node.post:
                cid = walk(child, lab)
                rows[cid - 1][2] = my_id
            return my_id

        root_id = walk(self, "root")
        rows[root_id - 1][2] = 0
        return [tuple(r) for r in rows]


# ---------------------------------------------------------------------------
# Lexicon
# ---------------------------------------------------------------------------

PEOPLE = [("man", "men"), ("woman", "women"), ("boy", "boys"),
          ("girl", "girls"), ("child", "children"), ("person", "people"),
          ("lady", "ladies"), ("player", "players"), ("skier", "skiers"),
          ("surfer", "surfers"), ("officer", "officers"),
          ("rider", "riders"), ("chef", "chefs"), ("worker", "workers"),
          ("guy", "guys"), ("kid", "kids"), ("baker", "bakers"),
          ("farmer", "farmers"), ("cowboy", "cowboys"),
          ("soldier", "soldiers"), ("clown", "clowns"),
          ("skateboarder", "skateboarders"), ("batter", "batters"),
          ("pitcher", "pitchers"), ("catcher", "catchers"),
          ("jockey", "jockeys"), ("pedestrian", "pedestrians"),
          ("passenger", "passengers"), ("tourist", "tourists"),
          ("baby", "babies"), ("pilot", "pilots"), ("driver", "drivers"),
          ("coach", "coaches"), ("referee", "referees"),
          ("umpire", "umpires"), ("vendor", "vendors"),
          ("shopper", "shoppers"), ("waiter", "waiters"),
          ("bride", "brides"), ("groom", "grooms"),
          ("dancer", "dancers"), ("singer", "singers"),
          ("artist", "artists"), ("skater", "skaters"),
          ("snowboarder", "snowboarders"), ("climber", "climbers"),
          ("hiker", "hikers"), ("biker", "bikers"),
          ("cyclist", "cyclists"), ("runner", "runners"),
          ("swimmer", "swimmers"), ("fisherman", "fishermen"),
          ("photographer", "photographers"), ("teacher", "teachers"),
          ("doctor", "doctors"), ("nurse", "nurses"),
          ("mother", "mothers"), ("father", "fathers"),
          ("parent", "parents"), ("daughter", "daughters"),
          ("son", "sons"), ("sister", "sisters"),
          ("brother", "brothers"), ("friend", "friends"),
          ("family", "families"), ("team", "teams")]
ANIMALS = [("dog", "dogs"), ("cat", "cats"), ("horse", "horses"),
           ("bird", "birds"), ("elephant", "elephants"),
           ("giraffe", "giraffes"), ("zebra", "zebras"), ("bear", "bears"),
           ("sheep", "sheep"), ("cow", "cows"), ("puppy", "puppies"),
           ("kitten", "kittens"), ("duck", "ducks"), ("goat", "goats"),
           ("monkey", "monkeys"), ("pigeon", "pigeons"), ("lamb", "lambs"),
           ("owl", "owls"), ("pony", "ponies"), ("bunny", "bunnies"),
           ("penguin", "penguins"), ("flamingo", "flamingos"),
           ("swan", "swans"), ("rabbit", "rabbits"),
           ("squirrel", "squirrels"), ("turtle", "turtles"),
           ("frog", "frogs"), ("dolphin", "dolphins"),
           ("whale", "whales"), ("shark", "sharks"), ("crab", "crabs"),
           ("butterfly", "butterflies"), ("bee", "bees"),
           ("spider", "spiders"), ("bull", "bulls"), ("yak", "yaks"),
           ("camel", "camels"), ("donkey", "donkeys"),
           ("rooster", "roosters"), ("chicken", "chickens"),
           ("pig", "pigs"), ("goose", "geese"), ("fox", "foxes")]
THINGS = [("table", "tables"), ("bench", "benches"), ("chair", "chairs"),
          ("plate", "plates"), ("bowl", "bowls"), ("cup", "cups"),
          ("bottle", "bottles"), ("umbrella", "umbrellas"),
          ("surfboard", "surfboards"), ("skateboard", "skateboards"),
          ("laptop", "laptops"), ("phone", "phones"), ("clock", "clocks"),
          ("sign", "signs"), ("kite", "kites"), ("racket", "rackets"),
          ("racquet", "racquets"), ("bat", "bats"), ("ball", "balls"),
          ("book", "books"), ("cake", "cakes"), ("pizza", "pizzas"),
          ("sandwich", "sandwiches"), ("donut", "donuts"),
          ("banana", "bananas"), ("apple", "apples"),
          ("carrot", "carrots"), ("hydrant", "hydrants"),
          ("toilet", "toilets"), ("sink", "sinks"), ("mirror", "mirrors"),
          ("towel", "towels"), ("couch", "couches"), ("sofa", "sofas"),
          ("television", "televisions"), ("tv", "tvs"),
          ("keyboard", "keyboards"), ("vase", "vases"), ("pot", "pots"),
          ("pan", "pans"), ("knife", "knives"), ("fork", "forks"),
          ("spoon", "spoons"), ("backpack", "backpacks"),
          ("suitcase", "suitcases"), ("helmet", "helmets"),
          ("hat", "hats"), ("jacket", "jackets"), ("shirt", "shirts"),
          ("dress", "dresses"), ("tie", "ties"), ("boot", "boots"),
          ("glove", "gloves"), ("scarf", "scarves"), ("train", "trains"),
          ("bus", "buses"), ("car", "cars"), ("truck", "trucks"),
          ("motorcycle", "motorcycles"), ("bicycle", "bicycles"),
          ("bike", "bikes"), ("boat", "boats"), ("airplane", "airplanes"),
          ("plane", "planes"), ("wagon", "wagons"), ("door", "doors"),
          ("window", "windows"), ("wall", "walls"), ("shelf", "shelves"),
          ("counter", "counters"), ("stove", "stoves"), ("oven", "ovens"),
          ("fridge", "fridges"), ("refrigerator", "refrigerators"),
          ("microwave", "microwaves"), ("lamp", "lamps"), ("bed", "beds"),
          ("pillow", "pillows"), ("blanket", "blankets"), ("rug", "rugs"),
          ("desk", "desks"), ("drawer", "drawers"),
          ("cabinet", "cabinets"), ("tray", "trays"),
          ("basket", "baskets"), ("box", "boxes"), ("bag", "bags"),
          ("frisbee", "frisbees"), ("flower", "flowers"),
          ("moped", "mopeds"), ("scooter", "scooters"),
          ("horn", "horns"), ("net", "nets"), ("leash", "leashes"),
          ("saddle", "saddles"), ("collar", "collars"),
          ("beard", "beards"), ("mustache", "mustaches"),
          ("color", "colors"), ("tomato", "tomatoes"),
          ("mushroom", "mushrooms"), ("olive", "olives"),
          ("onion", "onions"), ("pepper", "peppers"),
          ("strawberry", "strawberries"), ("grape", "grapes"),
          ("vegetable", "vegetables"), ("lemon", "lemons"),
          ("egg", "eggs"), ("pie", "pies"), ("dessert", "desserts"),
          ("cookie", "cookies"), ("muffin", "muffins"),
          ("burger", "burgers"), ("hotdog", "hotdogs"),
          ("suit", "suits"), ("sweater", "sweaters"),
          ("coat", "coats"), ("uniform", "uniforms"),
          ("costume", "costumes"), ("outfit", "outfits"),
          ("cap", "caps"), ("crown", "crowns"),
          ("curtain", "curtains"), ("ladder", "ladders"),
          ("bucket", "buckets"), ("broom", "brooms"),
          ("rope", "ropes"), ("chain", "chains"), ("wire", "wires"),
          ("screen", "screens"), ("monitor", "monitors"),
          ("camera", "cameras"), ("snowboard", "snowboards"),
          ("sled", "sleds"), ("kayak", "kayaks"), ("canoe", "canoes"),
          ("raft", "rafts"), ("propeller", "propellers"),
          ("trick", "tricks"), ("game", "games"), ("crust", "crusts"),
          ("menu", "menus"), ("logo", "logos"), ("ramp", "ramps"),
          ("toy", "toys"), ("seat", "seats"), ("scheme", "schemes"),
          ("intent", "intents"), ("pattern", "patterns"),
          ("design", "designs"), ("stripe", "stripes"),
          ("tree", "trees"), ("branch", "branches"), ("rock", "rocks"),
          ("leaf", "leaves"), ("fence", "fences"), ("pole", "poles"),
          ("wave", "waves"), ("candle", "candles"), ("balloon", "balloons"),
          ("toothbrush", "toothbrushes"), ("remote", "remotes"),
          ("banner", "banners"), ("statue", "statues"), ("tower", "towers"),
          ("wheel", "wheels"), ("engine", "engines"), ("track", "tracks"),
          ("platform", "platforms"), ("meal", "meals"), ("salad", "salads"),
          ("soup", "soups"), ("bread", "breads"), ("cheese", "cheeses"),
          ("glass", "glasses"), ("mug", "mugs"), ("napkin", "napkins")]
PLACES = [("street", "streets"), ("beach", "beaches"), ("field", "fields"),
          ("park", "parks"), ("room", "rooms"), ("kitchen", "kitchens"),
          ("bathroom", "bathrooms"), ("bedroom", "bedrooms"),
          ("sidewalk", "sidewalks"), ("hill", "hills"),
          ("mountain", "mountains"), ("lake", "lakes"),
          ("ocean", "oceans"), ("river", "rivers"), ("pond", "ponds"),
          ("court", "courts"), ("station", "stations"), ("yard", "yards"),
          ("garden", "gardens"), ("market", "markets"),
          ("airport", "airports"), ("harbor", "harbors"), ("zoo", "zoos"),
          ("forest", "forests"), ("road", "roads"), ("highway", "highways"),
          ("bridge", "bridges"), ("tunnel", "tunnels"), ("alley", "alleys"),
          ("corner", "corners"), ("lot", "lots"), ("garage", "garages"),
          ("meadow", "meadows"), ("plaza", "plazas"), ("porch", "porches"),
          ("driveway", "driveways"), ("stadium", "stadiums"),
          ("restaurant", "restaurants"), ("store", "stores"),
          ("building", "buildings"), ("house", "houses"),
          ("city", "cities"), ("town", "towns"), ("village", "villages"),
          ("countryside", "countrysides"), ("pier", "piers"),
          ("shore", "shores"), ("coast", "coasts"), ("cliff", "cliffs"),
          ("valley", "valleys"), ("desert", "deserts"),
          ("island", "islands"), ("cave", "caves"), ("trail", "trails"),
          ("path", "paths"), ("lawn", "lawns"),
          ("courtyard", "courtyards"), ("balcony", "balconies"),
          ("rooftop", "rooftops"), ("roof", "roofs"),
          ("hallway", "hallways"), ("lobby", "lobbies"),
          ("office", "offices"), ("classroom", "classrooms"),
          ("library", "libraries"), ("museum", "museums"),
          ("church", "churches"), ("castle", "castles"),
          ("barn", "barns"), ("shed", "sheds"), ("bakery", "bakeries"),
          ("cafe", "cafes"), ("hotel", "hotels"),
          ("hospital", "hospitals"), ("school", "schools"),
          ("mall", "malls"), ("gym", "gyms"), ("slope", "slopes"),
          ("runway", "runways"), ("intersection", "intersections"),
          ("crosswalk", "crosswalks")]
ADJS = ["red", "blue", "green", "black", "white", "brown", "gray",
        "orange", "purple", "pink", "yellow", "golden", "dark", "light",
        "big", "small", "large", "little", "tall", "short", "long", "old",
        "young", "new", "wide", "narrow", "high", "low", "bright", "open",
        "full", "empty", "wet", "dry", "clean", "dirty", "shiny", "rusty",
        "fluffy", "furry", "striped", "spotted", "wooden", "metal",
        "plastic", "modern", "vintage", "colorful", "cloudy", "sunny",
        "snowy", "rainy", "grassy", "sandy", "rocky", "busy", "quiet",
        "crowded", "beautiful", "cute", "tiny", "huge", "giant",
        "delicious", "fresh", "ripe", "fancy", "plain", "round", "square",
        "flat", "deep", "shallow", "warm", "cold", "hot", "cool", "soft",
        "hard", "heavy", "pretty", "lovely", "curly", "friendly",
        "double", "single", "stuffed", "silver", "tan", "beige", "burgundy",
        "teal", "maroon", "navy", "crispy", "crunchy", "juicy",
        "tasty", "sweet", "blurry", "foggy", "misty", "icy", "muddy",
        "dusty", "smoky", "hazy", "messy", "tidy", "neat", "cozy",
        "ornate", "elegant", "rustic", "antique", "skinny", "chubby",
        "thin", "elderly", "bald", "bearded", "shirtless", "happy",
        "sad", "calm", "peaceful", "scenic", "urban", "rural",
        "distant", "nearby", "leafy", "lush", "steep", "windy"]
# past participles used attributively and predicatively
PARTICIPLES = ["parked", "sliced", "painted", "covered", "filled",
               "topped", "lined", "stacked", "piled", "decorated",
               "grilled", "toasted", "baked", "melted", "wrapped",
               "loaded", "crowded", "surrounded", "mounted", "displayed",
               "scattered", "arranged", "placed", "docked", "perched",
               "tied", "attached", "folded", "broken", "worn", "torn",
               "frozen", "hidden", "drawn", "carved", "printed", "written"]
# transitive verbs: (VBZ, VBG, VBD, VBN, base VB)
V_TRANS = [("holds", "holding", "held", "held", "hold"),
           ("rides", "riding", "rode", "ridden", "ride"),
           ("eats", "eating", "ate", "eaten", "eat"),
           ("wears", "wearing", "wore", "worn", "wear"),
           ("carries", "carrying", "carried", "carried", "carry"),
           ("watches", "watching", "watched", "watched", "watch"),
           ("hits", "hitting", "hit", "hit", "hit"),
           ("throws", "throwing", "threw", "thrown", "throw"),
           ("catches", "catching", "caught", "caught", "catch"),
           ("cuts", "cutting", "cut", "cut", "cut"),
           ("pushes", "pushing", "pushed", "pushed", "push"),
           ("pulls", "pulling", "pulled", "pulled", "pull"),
           ("grabs", "grabbing", "grabbed", "grabbed", "grab"),
           ("chases", "chasing", "chased", "chased", "chase"),
           ("feeds", "feeding", "fed", "fed", "feed"),
           ("pets", "petting", "petted", "petted", "pet"),
           ("touches", "touching", "touched", "touched", "touch"),
           ("reads", "reading", "read", "read", "read"),
           ("swings", "swinging", "swung", "swung", "swing"),
           ("serves", "serving", "served", "served", "serve"),
           ("kicks", "kicking", "kicked", "kicked", "kick"),
           ("tosses", "tossing", "tossed", "tossed", "toss"),
           ("bites", "biting", "bit", "bitten", "bite"),
           ("drives", "driving", "drove", "driven", "drive"),
           ("drinks", "drinking", "drank", "drunk", "drink"),
           ("washes", "washing", "washed", "washed", "wash"),
           ("licks", "licking", "licked", "licked", "lick"),
           ("paints", "painting", "painted", "painted", "paint"),
           ("slices", "slicing", "sliced", "sliced", "slice"),
           ("makes", "making", "made", "made", "make"),
           ("uses", "using", "used", "used", "use"),
           ("shares", "sharing", "shared", "shared", "share"),
           ("includes", "including", "included", "included", "include"),
           ("has", "having", "had", "had", "have"),
           ("flies", "flying", "flew", "flown", "fly"),
           ("crosses", "crossing", "crossed", "crossed", "cross"),
           ("performs", "performing", "performed", "performed", "perform"),
           ("does", "doing", "did", "done", "do")]
# intransitive verbs: (VBZ, VBG)
V_INTRANS = [("stands", "standing"), ("sits", "sitting"),
             ("sleeps", "sleeping"), ("walks", "walking"),
             ("runs", "running"), ("smiles", "smiling"),
             ("waits", "waiting"), ("poses", "posing"),
             ("grazes", "grazing"), ("jumps", "jumping"),
             ("skis", "skiing"), ("surfs", "surfing"),
             ("skates", "skating"), ("swims", "swimming"),
             ("laughs", "laughing"), ("barks", "barking"),
             ("rests", "resting"), ("leans", "leaning"),
             ("kneels", "kneeling"), ("stretches", "stretching"),
             ("waves", "waving"), ("dances", "dancing"),
             ("sings", "singing"), ("yawns", "yawning"),
             ("crawls", "crawling"), ("glides", "gliding"),
             ("soars", "soaring"), ("floats", "floating"),
             ("travels", "traveling"), ("grins", "grinning"),
             ("lays", "laying"), ("lies", "lying"),
             ("hangs", "hanging"), ("plays", "playing"),
             ("lands", "landing"), ("races", "racing"),
             ("strolls", "strolling"), ("wades", "wading"),
             ("leaps", "leaping"), ("dives", "diving"),
             ("talks", "talking"), ("looks", "looking"),
             ("gazes", "gazing"), ("stares", "staring"),
             ("points", "pointing"), ("cheers", "cheering"),
             ("claps", "clapping"), ("bends", "bending"),
             ("balances", "balancing"), ("spins", "spinning"),
             ("slides", "sliding"), ("rolls", "rolling"),
             ("bounces", "bouncing"), ("splashes", "splashing"),
             ("inhales", "inhaling"), ("exhales", "exhaling"),
             ("snowboards", "snowboarding"), ("sunbathes", "sunbathing"),
             ("squats", "squatting"), ("crouches", "crouching")]
CONTAINERS = [("group", "of"), ("bunch", "of"), ("herd", "of"),
              ("couple", "of"), ("bowl", "of"), ("plate", "of"),
              ("slice", "of"), ("cup", "of"), ("glass", "of"),
              ("vase", "of"), ("row", "of"), ("pair", "of"),
              ("stack", "of"), ("pile", "of"), ("basket", "of"),
              ("crowd", "of"), ("flock", "of"), ("variety", "of"),
              ("loaf", "of"), ("piece", "of"), ("bundle", "of"),
              ("tray", "of"), ("pot", "of"), ("line", "of")]
MASS = ["food", "water", "snow", "grass", "sand", "fruit", "soup",
        "coffee", "tea", "wine", "juice", "milk", "rice", "pasta",
        "bread", "cheese", "meat", "cereal", "sky", "air", "hair",
        "luggage", "furniture", "traffic", "graffiti", "broccoli",
        "lettuce", "bacon", "toast", "ketchup", "mustard", "spinach",
        "cabbage", "corn", "celery", "chocolate", "sauce", "foam",
        "smoke", "fog", "mud", "dust", "gravel", "dirt", "ice",
        "sunlight", "shade", "foliage", "greenery", "seaweed"]
PREPS = ["on", "in", "at", "near", "under", "over", "behind", "beside",
         "above", "below", "by", "against", "along", "across", "around",
         "atop", "beneath", "inside", "outside", "between", "through",
         "past", "underneath", "with", "upon"]
MWPREPS = ["in front of", "on top of", "next to", "close to"]
COMPOUND_PAIRS = [("tennis", "court"), ("tennis", "player"),
                  ("baseball", "field"), ("baseball", "game"),
                  ("soccer", "ball"), ("traffic", "light"),
                  ("street", "corner"), ("city", "street"),
                  ("train", "station"), ("fire", "truck"),
                  ("fire", "hydrant"), ("police", "car"),
                  ("coffee", "table"), ("coffee", "mug"),
                  ("fruit", "stand"), ("flower", "pot"),
                  ("birthday", "cake"), ("wedding", "dress"),
                  ("cell", "phone"), ("computer", "desk"),
                  ("wine", "bottle"), ("pizza", "box"),
                  ("teddy", "bear"), ("stop", "sign"),
                  ("palm", "tree"), ("skate", "park"),
                  ("picnic", "table"), ("park", "bench"),
                  ("dirt", "road"), ("grass", "field"),
                  ("brick", "wall"), ("stone", "bridge"),
                  ("snow", "board"), ("surf", "board"),
                  ("motor", "bike"), ("race", "car"),
                  ("kitchen", "counter"), ("bathroom", "sink"),
                  ("living", "room"), ("dining", "table"),
                  ("ski", "slope"), ("ski", "lift"),
                  ("horse", "track"), ("bus", "stop"),
                  ("subway", "train"), ("ice", "rink"),
                  ("hair", "net"), ("life", "preserver"),
                  ("hot", "dog"), ("clock", "tower"),
                  ("screen", "tv"), ("top", "oven"),
                  ("color", "scheme"), ("tree", "branch"),
                  ("water", "bottle"), ("street", "sign")]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def noun(w: str, plural: bool = False) -> N:
    return N(w, "NNS" if plural else "NN")


def NP(head: N, d: Optional[str] = "a", adjs: Sequence[str] = (),
       comps: Sequence[str] = (), num: Optional[str] = None) -> N:
    pre: List[Tuple[N, str]] = []
    if d:
        pre.append((N(d, "DT"), "det"))
    if num:
        pre.append((N(num, "CD"), "nummod"))
    for a in adjs:
        pre.append((N(a, "JJ"), "amod"))
    for c in comps:
        pre.append((N(c, "NN"), "compound"))
    head.pre = pre + head.pre
    return head


def with_case(np_node: N, prep: str) -> N:
    np_node.pre.insert(0, (N(prep, "IN"), "case"))
    return np_node


def pp_on(host: N, prep: str, np_node: N, label: str) -> N:
    host.post.append((with_case(np_node, prep), label))
    return host


def vbg(forms) -> N:
    return N(forms[1], "VBG")


def vbz(forms) -> N:
    return N(forms[0], "VBZ")


# ---------------------------------------------------------------------------
# Templates — each returns a root N
# ---------------------------------------------------------------------------

def _pick_np(rng: random.Random, pools, plural_p: float = 0.2,
             adj_p: float = 0.45, comp_p: float = 0.1,
             allow_bare: bool = False) -> N:
    sg, pl = rng.choice(rng.choice(pools))
    plural = rng.random() < plural_p
    head = noun(pl if plural else sg, plural)
    adjs = []
    if rng.random() < adj_p:
        adjs.append(rng.choice(ADJS))
        if rng.random() < 0.18:
            adjs.append(rng.choice(ADJS))
    comps = []
    if rng.random() < comp_p:
        comps.append(rng.choice(MASS))
    if plural:
        if rng.random() < 0.4:
            return NP(head, d=None, adjs=adjs, comps=comps,
                      num=rng.choice(["two", "three", "four", "five"]))
        return NP(head, d=None, adjs=adjs, comps=comps)
    d = None if (allow_bare and rng.random() < 0.2) else \
        rng.choice(["a", "a", "a", "the"])
    if d == "a" and (adjs + comps + [head.word])[0][0] in "aeiou":
        d = "an"
    return NP(head, d=d, adjs=adjs, comps=comps)


def t_bare_np(rng: random.Random) -> N:
    return _pick_np(rng, [PEOPLE, ANIMALS, THINGS], adj_p=0.9)


def t_np_pp(rng: random.Random) -> N:
    host = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    prep = rng.choice(PREPS if rng.random() < 0.8 else MWPREPS)
    return pp_on(host, prep, _pick_np(rng, [PLACES, THINGS]), "nmod")


def t_np_pp_chain(rng: random.Random) -> N:
    host = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    mid = _pick_np(rng, [THINGS, PLACES])
    pp_on(host, rng.choice(PREPS), mid, "nmod")
    pp_on(mid, rng.choice(PREPS), _pick_np(rng, [PLACES]), "nmod")
    return host


def t_of_np(rng: random.Random) -> N:
    c, of = rng.choice(CONTAINERS)
    host = NP(noun(c), d="a")
    def compound_inner() -> N:  # 'rows of palm trees'
        mod, hd = rng.choice(COMPOUND_PAIRS)
        return NP(noun(hd + ("es" if hd.endswith(("s", "ch", "sh"))
                             else "s"), True), d=None, comps=[mod])

    inner = rng.choice([lambda: NP(noun(rng.choice(MASS)), d=None),
                        lambda: _pick_np(rng, [THINGS, ANIMALS, PEOPLE],
                                         plural_p=1.0),
                        compound_inner])()
    if rng.random() < 0.25:  # 'a row of parked cars'
        inner.pre.insert(0, (N(rng.choice(PARTICIPLES), "VBN"), "amod"))
    return pp_on(host, of, inner, "nmod")


def t_of_np_content_acts(rng: random.Random) -> N:
    """Participial modifier after an of-chain attaches to the CONTENT."""
    c, of = rng.choice(CONTAINERS[:8])  # group/bunch/herd/couple/bowl...
    host = NP(noun(c), d="a")
    sg, pl = rng.choice(rng.choice([PEOPLE, ANIMALS]))
    inner = NP(noun(pl, True), d=None)
    pp_on(host, of, inner, "nmod")
    v = vbg(rng.choice(V_INTRANS))
    pp_on(v, rng.choice(PREPS), _pick_np(rng, [PLACES]), "obl")
    inner.post.append((v, "acl"))
    return host


def t_of_np_container_locates(rng: random.Random) -> N:
    """Locative PP after an of-chain attaches to the CONTAINER."""
    c, of = rng.choice(CONTAINERS)
    host = NP(noun(c), d="a")
    inner = NP(noun(rng.choice(MASS)), d=None)
    pp_on(host, of, inner, "nmod")
    prep = rng.choice(["on", "on top of", "near", "beside", "in"])
    return pp_on(host, prep, _pick_np(rng, [THINGS, PLACES]), "nmod")


def t_acl_obj(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS], allow_bare=True)
    v = vbg(rng.choice(V_TRANS))
    v.post.append((_pick_np(rng, [THINGS, ANIMALS]), "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_acl_obl(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS], allow_bare=True)
    v = vbg(rng.choice(V_INTRANS))
    prep = rng.choice(PREPS if rng.random() < 0.75 else MWPREPS)
    pp_on(v, prep, _pick_np(rng, [PLACES, THINGS]), "obl")
    subj.post.append((v, "acl"))
    return subj


def t_acl_obj_nmod(rng: random.Random) -> N:
    """PP after the object attaches to the object (nearest-NP)."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS], allow_bare=True)
    v = vbg(rng.choice(V_TRANS))
    obj = _pick_np(rng, [THINGS])
    pp_on(obj, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]), "nmod")
    v.post.append((obj, "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_np_pp_acl_high(rng: random.Random) -> N:
    """'a man in a jacket riding a bicycle' — acl attaches to the person."""
    subj = _pick_np(rng, [PEOPLE])
    wear = _pick_np(rng, [THINGS])
    pp_on(subj, rng.choice(["in", "with"]), wear, "nmod")
    v = vbg(rng.choice(V_TRANS))
    v.post.append((_pick_np(rng, [THINGS, ANIMALS]), "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_relcl(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbz(rng.choice(V_TRANS))
    wh = rng.choice(["that", "who", "which"])
    v.pre.append((N(wh, "WDT"), "nsubj"))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    subj.post.append((v, "relcl"))
    return subj


def t_relcl_aux_vbg(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbg(rng.choice(V_TRANS))
    wh = rng.choice(["that", "who"])
    v.pre.append((N(wh, "WDT"), "nsubj"))
    v.pre.append((N("is", "VBZ"), "aux"))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    subj.post.append((v, "relcl"))
    return subj


def t_relcl_cop_adj(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    pred = N(rng.choice(ADJS), "JJ")
    pred.pre.append((N("that", "WDT"), "nsubj"))
    pred.pre.append((N("is", "VBZ"), "cop"))
    subj.post.append((pred, "relcl"))
    return subj


def t_relcl_cop_pp(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    pred = _pick_np(rng, [THINGS, PLACES])
    pred.pre.insert(0, (N("is", "VBZ"), "cop"))
    pred.pre.insert(0, (N("that", "WDT"), "nsubj"))
    with_case(pred, rng.choice(PREPS))
    # order: that is on a leash -> case must come after cop: rebuild
    pred.pre.sort(key=lambda cl: {"nsubj": 0, "cop": 1, "case": 2,
                                  "det": 3, "nummod": 4, "amod": 5,
                                  "compound": 6}.get(cl[1], 9))
    subj.post.append((pred, "relcl"))
    return subj


def t_cop_adj(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS, PLACES])
    pred = N(rng.choice(ADJS), "JJ")
    if rng.random() < 0.25:
        pred.pre.append((N(rng.choice(["very", "really", "extremely"]),
                           "RB"), "advmod"))
    pred.pre.insert(0, (N("is", "VBZ"), "cop"))
    pred.pre.insert(0, (subj, "nsubj"))
    return pred


def t_cop_adj_conj(rng: random.Random) -> N:
    subj = _pick_np(rng, [THINGS, PLACES, ANIMALS])
    pred = N(rng.choice(ADJS), "JJ")
    pred.pre.insert(0, (N("is", "VBZ"), "cop"))
    pred.pre.insert(0, (subj, "nsubj"))
    second = N(rng.choice(ADJS), "JJ")
    second.pre.append((N("and", "CC"), "cc"))
    pred.post.append((second, "conj"))
    return pred


def t_cop_pp(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    pred = _pick_np(rng, [THINGS, PLACES])
    with_case(pred, rng.choice(PREPS if rng.random() < 0.7 else MWPREPS))
    pred.pre.insert(0, (N("is", "VBZ"), "cop"))
    pred.pre.insert(0, (subj, "nsubj"))
    return pred


def t_finite_trans(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbz(rng.choice(V_TRANS))
    v.pre.append((subj, "nsubj"))
    v.post.append((_pick_np(rng, [THINGS, ANIMALS]), "obj"))
    return v


def t_finite_trans_aux(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbg(rng.choice(V_TRANS))
    v.pre.append((subj, "nsubj"))
    v.pre.append((N("is", "VBZ"), "aux"))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    return v


def t_finite_obl(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    forms = rng.choice(V_INTRANS)
    v = vbg(forms) if rng.random() < 0.4 else vbz(forms)
    if v.tag == "VBG":
        v.pre.append((N("is", "VBZ"), "aux"))
    v.pre.insert(0, (subj, "nsubj"))
    prep = rng.choice(PREPS + ["down", "up"])
    tag_label = ("obl", prep)
    pp_on(v, prep, _pick_np(rng, [PLACES, THINGS]), tag_label[0])
    return v


def t_finite_intrans(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbz(rng.choice(V_INTRANS))
    v.pre.append((subj, "nsubj"))
    return v


def t_subj_coord(rng: random.Random) -> N:
    a = _pick_np(rng, [PEOPLE, ANIMALS])
    b = _pick_np(rng, [PEOPLE, ANIMALS])
    b.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    v = vbg(rng.choice(V_INTRANS))
    pp_on(v, rng.choice(PREPS), _pick_np(rng, [PLACES]), "obl")
    a.post.append((v, "acl"))
    return a


def t_with_coord(rng: random.Random) -> N:
    host = _pick_np(rng, [PLACES, THINGS])
    a = _pick_np(rng, [THINGS])
    b = _pick_np(rng, [THINGS])
    b.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    return pp_on(host, "with", a, "nmod")


def t_asyndetic_list(rng: random.Random) -> N:
    """'a couch a table and a television' (commas stripped upstream)."""
    host = _pick_np(rng, [PLACES])
    items = rng.sample(THINGS, 3)
    a = NP(noun(items[0][0]), d="a")
    b = NP(noun(items[1][0]), d="a")
    c = NP(noun(items[2][0]), d="a")
    c.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    a.post.append((c, "conj"))
    return pp_on(host, "with", a, "nmod")


def t_poss(rng: random.Random) -> N:
    owner = _pick_np(rng, [PEOPLE, ANIMALS], adj_p=0.2)
    owner.post.append((N("'s", "POS"), "case"))
    owned = NP(noun(rng.choice(THINGS)[0]), d=None)
    owned.pre.insert(0, (owner, "poss"))
    if rng.random() < 0.6:
        pp_on(owned, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]),
              "nmod")
    return owned


def t_there_is(rng: random.Random) -> N:
    plural = rng.random() < 0.4
    v = N("are" if plural else "is", "VBP" if plural else "VBZ")
    v.pre.append((N("there", "EX"), "expl"))
    subj = _pick_np(rng, [ANIMALS, THINGS], plural_p=1.0 if plural else 0.0)
    pp_on(subj, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]), "nmod")
    v.post.append((subj, "nsubj"))
    return v


def t_passive_acl(rng: random.Random) -> N:
    """'a table covered with books' — VBN acl, obl absorbed by rules."""
    subj = _pick_np(rng, [THINGS, PLACES])
    v = N(rng.choice(PARTICIPLES), "VBN")
    pp_on(v, rng.choice(["with", "in", "by"]),
          _pick_np(rng, [THINGS, ANIMALS], plural_p=0.7), "obl")
    subj.post.append((v, "acl"))
    return subj


def t_passive_cop(rng: random.Random) -> N:
    """'a bench is covered in snow' — VBN with aux."""
    subj = _pick_np(rng, [THINGS, PLACES])
    v = N(rng.choice(PARTICIPLES), "VBN")
    v.pre.append((subj, "nsubj"))
    v.pre.append((N("is", "VBZ"), "aux"))
    pp_on(v, rng.choice(["with", "in", "by"]),
          NP(noun(rng.choice(MASS)), d=None), "obl")
    return v


def t_vp_coord(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v1 = vbg(rng.choice(V_INTRANS))
    v2 = vbg(rng.choice(V_TRANS))
    v2.pre.append((N("and", "CC"), "cc"))
    v2.post.append((_pick_np(rng, [THINGS]), "obj"))
    v1.post.append((v2, "conj"))
    subj.post.append((v1, "acl"))
    return subj


def t_while_advcl(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v1 = vbg(rng.choice(V_INTRANS))
    v2 = vbg(rng.choice(V_TRANS))
    v2.pre.append((N("while", "IN"), "mark"))
    v2.post.append((_pick_np(rng, [THINGS]), "obj"))
    v1.post.append((v2, "advcl"))
    subj.post.append((v1, "acl"))
    return subj


def t_as_pronoun_advcl(rng: random.Random) -> N:
    """'a man smiles as he holds a cup' — pronoun subject clause."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v1 = vbz(rng.choice(V_INTRANS))
    v1.pre.append((subj, "nsubj"))
    v2 = vbz(rng.choice(V_TRANS))
    v2.pre.append((N("as", "IN"), "mark"))
    v2.pre.append((N(rng.choice(["he", "she", "it", "they"]), "PRP"),
                   "nsubj"))
    v2.post.append((_pick_np(rng, [THINGS]), "obj"))
    v1.post.append((v2, "advcl"))
    return v1


def t_control(rng: random.Random) -> N:
    """'a girl preparing to blow out her candle' — contentful control."""
    subj = _pick_np(rng, [PEOPLE])
    ctrl = N(rng.choice(["preparing", "trying", "attempting", "waiting"]),
             "VBG")
    forms = rng.choice(V_TRANS)
    inf = N(forms[4], "VB")
    inf.pre.append((N("to", "TO"), "mark"))
    if rng.random() < 0.3:
        inf.post.append((N(rng.choice(["out", "up", "off"]), "RP"), "prt"))
    obj = _pick_np(rng, [THINGS])
    if rng.random() < 0.4:
        obj.pre = [(N(rng.choice(["her", "his", "their"]), "PRP$"), "poss")]
    inf.post.append((obj, "obj"))
    ctrl.post.append((inf, "xcomp"))
    subj.post.append((ctrl, "acl"))
    return subj


def t_raising(rng: random.Random) -> N:
    """'a truck that seems to be parked behind a fence'."""
    subj = _pick_np(rng, [THINGS])
    seem = N(rng.choice(["seems", "appears"]), "VBZ")
    seem.pre.append((N("that", "WDT"), "nsubj"))
    part = N(rng.choice(PARTICIPLES[:8]), "VBN")
    part.pre.append((N("to", "TO"), "mark"))
    part.pre.append((N("be", "VB"), "aux"))
    if rng.random() < 0.5:
        part.post.append((N(rng.choice(["illegally", "neatly", "carefully",
                                        "partially"]), "RB"), "advmod"))
    pp_on(part, rng.choice(PREPS),
          _pick_np(rng, [THINGS, PLACES]), "obl")
    seem.post.append((part, "xcomp"))
    subj.post.append((seem, "relcl"))
    return subj


def t_getting_ready(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE])
    get = N("getting", "VBG")
    ready = N("ready", "JJ")
    forms = rng.choice(V_TRANS)
    inf = N(forms[4], "VB")
    inf.pre.append((N("to", "TO"), "mark"))
    inf.post.append((_pick_np(rng, [THINGS]), "obj"))
    ready.post.append((inf, "xcomp"))
    get.post.append((ready, "xcomp"))
    subj.post.append((get, "acl"))
    return subj


def t_particle(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    base = rng.choice([("blowing", "out"), ("taking", "off"),
                       ("picking", "up"), ("putting", "down"),
                       ("holding", "up"), ("setting", "up")])
    v = N(base[0], "VBG")
    v.post.append((N(base[1], "RP"), "prt"))
    if base[0] != "taking":
        v.post.append((_pick_np(rng, [THINGS]), "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_close_up(rng: random.Random) -> N:
    host = NP(noun("up"), d="a", adjs=["close"])
    inner = _pick_np(rng, [THINGS, ANIMALS])
    return pp_on(host, "of", inner, "nmod")


def t_each_other(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS], plural_p=1.0)
    v = vbg(rng.choice(V_INTRANS[:8]))
    other = N("other", "PRP")
    other.pre.append((N("next to", "IN"), "case"))
    other.pre.append((N("each", "DT"), "det"))
    v.post.append((other, "obl"))
    subj.post.append((v, "acl"))
    return subj


def t_depictive(rng: random.Random) -> N:
    subj = _pick_np(rng, [THINGS, ANIMALS])
    v = vbz(rng.choice(V_INTRANS[:6] + [("flies", "flying"),
                                        ("soars", "soaring"),
                                        ("hangs", "hanging")]))
    v.pre.append((subj, "nsubj"))
    v.post.append((N(rng.choice(["open", "high", "low", "still", "alone"]),
                     "JJ"), "advmod"))
    pp_on(v, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]), "obl")
    return v


def t_advmod_adj(rng: random.Random) -> N:
    host = _pick_np(rng, [THINGS, PLACES], adj_p=0.0)
    a = N(rng.choice(ADJS), "JJ")
    a.pre.append((N(rng.choice(["very", "partly", "really", "mostly",
                                "slightly"]), "RB"), "advmod"))
    host.pre.insert(len(host.pre), (a, "amod"))
    # adjective goes directly before the noun: efficient reorder
    host.pre.sort(key=lambda cl: {"case": 0, "det": 1, "nummod": 2,
                                  "amod": 3, "compound": 4}.get(cl[1], 9))
    return host


def t_attrib_participle(rng: random.Random) -> N:
    host = _pick_np(rng, [THINGS], plural_p=0.7, adj_p=0.0)
    host.pre.append((N(rng.choice(PARTICIPLES), "VBN"), "amod"))
    host.pre.sort(key=lambda cl: {"case": 0, "det": 1, "nummod": 2,
                                  "amod": 3, "compound": 4}.get(cl[1], 9))
    prep = rng.choice(PREPS)
    return pp_on(host, prep, _pick_np(rng, [PLACES]), "nmod")


def t_compound(rng: random.Random) -> N:
    mod, head = rng.choice(COMPOUND_PAIRS)
    if rng.random() < 0.3:
        # plural compound head, bare ("palm trees", "tennis courts")
        host = NP(noun(head + ("es" if head.endswith(("s", "ch", "sh"))
                               else "s"), True), d=None, comps=[mod])
    else:
        host = NP(noun(head), d="a", comps=[mod])
    if rng.random() < 0.3:
        host.pre.insert(1, (N(rng.choice(ADJS), "JJ"), "amod"))
    if rng.random() < 0.5:
        pp_on(host, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]),
              "nmod")
    return host


def t_triple_compound(rng: random.Random) -> N:
    trip = rng.choice([("stove", "top", "oven"), ("flat", "screen", "tv"),
                       ("ice", "cream", "cone"), ("fire", "station", "door"),
                       ("tennis", "court", "fence")])
    host = noun(trip[2])
    host.pre = [(N("a", "DT"), "det")]
    first_tag = "JJ" if trip[0] == "flat" else "NN"
    label0 = "amod" if trip[0] == "flat" else "compound"
    host.pre.append((N(trip[0], first_tag), label0))
    host.pre.append((N(trip[1], "NN"), "compound"))
    if rng.random() < 0.5:
        pp_on(host, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]),
              "nmod")
    return host


def _painting_hanging(rng: random.Random) -> N:
    """'an old painting hanging on a wall' — deverbal -ing noun head."""
    host = NP(noun("painting"), d="an",
              adjs=[rng.choice(["old", "large", "colorful"])])
    v = N("hanging", "VBG")
    pp_on(v, "on", _pick_np(rng, [THINGS, PLACES]), "obl")
    host.post.append((v, "acl"))
    return host


def t_nn_vb_ambig(rng: random.Random) -> N:
    """Surface forms that are nouns here, verbs elsewhere (and vice versa)."""
    pick = rng.choice([
        lambda: pp_on(NP(noun("watch"), d="a"), "on",
                      _pick_np(rng, [THINGS]), "nmod"),
        lambda: pp_on(NP(noun("park"), d="the"), "near",
                      _pick_np(rng, [PLACES]), "nmod"),
        lambda: pp_on(NP(noun("light"), d="a"), "on",
                      _pick_np(rng, [THINGS]), "nmod"),
        lambda: NP(noun("shirt"), d="a", adjs=["light", "blue"]),
        lambda: pp_on(NP(noun("painting"), d="an", adjs=["old"]), "on",
                      _pick_np(rng, [THINGS]), "nmod"),
        lambda: pp_on(NP(noun("building"), d="a", comps=["brick"]),
                      "behind", _pick_np(rng, [PLACES]), "nmod"),
        lambda: pp_on(NP(noun("top"), d="the"), "of",
                      _pick_np(rng, [THINGS, PLACES]), "nmod"),
        lambda: pp_on(NP(noun("back"), d="the"), "of",
                      _pick_np(rng, [THINGS]), "nmod"),
        lambda: pp_on(NP(noun("side"), d="the"), "of",
                      _pick_np(rng, [THINGS, PLACES]), "nmod"),
        lambda: pp_on(NP(noun("stand"), d="a", comps=["fruit"]), "on",
                      _pick_np(rng, [PLACES]), "nmod"),
        lambda: _painting_hanging(rng),
        lambda: pp_on(NP(noun("drawing"), d="a"), "of",
                      _pick_np(rng, [ANIMALS, THINGS]), "nmod"),
        lambda: pp_on(NP(noun("buildings", True), d=None, adjs=["tall"]),
                      "behind", _pick_np(rng, [PLACES, THINGS]), "nmod"),
        lambda: NP(noun("clothing"), d=None, adjs=[rng.choice(ADJS[:11])]),
    ])
    return pick()


def t_postposed_adj(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE], adj_p=0.4)
    subj.post.append((N(rng.choice(["barefoot", "barefoot", "asleep",
                                    "alone"]), "JJ"), "amod"))
    v = vbg(rng.choice(V_TRANS))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_acl_then_finite(rng: random.Random) -> N:
    """'a man wearing glasses talks on a phone' — acl inside subject."""
    subj = _pick_np(rng, [PEOPLE])
    mod = vbg(rng.choice(V_TRANS))
    mod.post.append((NP(noun(rng.choice(THINGS)[1], True), d=None), "obj"))
    subj.post.append((mod, "acl"))
    v = vbz(rng.choice(V_INTRANS))
    v.pre.append((subj, "nsubj"))
    pp_on(v, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]), "obl")
    return v


def t_cop_vp_coord(rng: random.Random) -> N:
    """'the room is clean and has a tv' — VP conj off a copular predicate."""
    subj = _pick_np(rng, [PLACES, THINGS])
    pred = N(rng.choice(ADJS), "JJ")
    pred.pre.append((subj, "nsubj"))
    pred.pre.append((N("is", "VBZ"), "cop"))
    pred.pre.sort(key=lambda cl: {"nsubj": 0, "cop": 1}.get(cl[1], 9))
    v = vbz(rng.choice(V_TRANS[:34]))
    v.pre.append((N("and", "CC"), "cc"))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    pred.post.append((v, "conj"))
    return pred


def t_postnominal_adj_of(rng: random.Random) -> N:
    """'a vase full of purple flowers' — postposed adjective, of-PP on the
    NOUN (the scene rules lift adjective-attached of-PPs the same way)."""
    host = _pick_np(rng, [THINGS], adj_p=0.2)
    host.post.append((N(rng.choice(["full", "empty"]), "JJ"), "amod"))
    inner = rng.choice([
        lambda: NP(noun(rng.choice(MASS)), d=None),
        lambda: _pick_np(rng, [THINGS], plural_p=1.0)])()
    pp_on(host, "of", inner, "nmod")
    return host


def t_asyndetic_bare(rng: random.Random) -> N:
    """'a table with plates cups and bowls' — comma-stripped bare list."""
    host = _pick_np(rng, [PLACES, THINGS])
    items = []
    for _ in range(3):
        if rng.random() < 0.35:
            items.append((rng.choice(MASS), False))
        else:
            items.append((rng.choice(THINGS)[1], True))
    rng.shuffle(items)
    a = NP(noun(items[0][0], items[0][1]), d=None)
    b = NP(noun(items[1][0], items[1][1]), d=None)
    c = NP(noun(items[2][0], items[2][1]), d=None)
    c.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    a.post.append((c, "conj"))
    return pp_on(host, "with", a, "nmod")


def t_obl_nmod_chain(rng: random.Random) -> N:
    """'a train travels over a bridge near the mountains' — PP chains on
    the oblique noun (nearest-NP)."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS, THINGS])
    forms = rng.choice(V_INTRANS)
    v = vbz(forms)
    v.pre.append((subj, "nsubj"))
    mid = _pick_np(rng, [PLACES, THINGS])
    pp_on(v, rng.choice(PREPS + ["down", "up"]), mid, "obl")
    pp_on(mid, rng.choice(PREPS), _pick_np(rng, [PLACES], plural_p=0.4),
          "nmod")
    return v


def t_obj_nmod_chain2(rng: random.Random) -> N:
    """obj + two chained PPs ('riding a bike on a road on a hillside')."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS], allow_bare=True)
    v = vbg(rng.choice(V_TRANS))
    obj = _pick_np(rng, [THINGS])
    mid = _pick_np(rng, [PLACES, THINGS])
    pp_on(obj, rng.choice(PREPS + ["up", "down"]), mid, "nmod")
    pp_on(mid, rng.choice(PREPS), _pick_np(rng, [PLACES]), "nmod")
    v.post.append((obj, "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_themed(rng: random.Random) -> N:
    """'a blue boat themed bathroom' — noun+participle premodifier stack."""
    sg, _pl = rng.choice(THINGS + ANIMALS)
    head = noun(rng.choice(["bathroom", "bedroom", "cake", "room", "party",
                            "kite", "balloon"]))
    part = rng.choice(["themed", "shaped", "colored", "printed"])
    pre: List[Tuple[N, str]] = [(N("a", "DT"), "det")]
    if rng.random() < 0.5:
        pre.append((N(rng.choice(ADJS[:11]), "JJ"), "amod"))
    pre.append((N(sg, "NN"), "compound"))
    pre.append((N(part, "VBN"), "amod"))
    head.pre = pre
    if rng.random() < 0.4:
        pp_on(head, rng.choice(PREPS), _pick_np(rng, [THINGS, PLACES]),
              "nmod")
    return head


def t_relcl_passive(rng: random.Random) -> N:
    """'walls that are painted blue' / 'a bench that is covered in snow'."""
    plural = rng.random() < 0.5
    subj = _pick_np(rng, [THINGS, PLACES], plural_p=1.0 if plural else 0.0)
    v = N(rng.choice(PARTICIPLES), "VBN")
    v.pre.append((N("that", "WDT"), "nsubj"))
    v.pre.append((N("are" if plural else "is", "VBP" if plural else "VBZ"),
                  "aux"))
    if rng.random() < 0.5:
        pred = N(rng.choice(ADJS[:11]), "JJ")
        if rng.random() < 0.3:
            pred.pre.append((N(rng.choice(["baby", "dark", "navy"]),
                               "JJ"), "amod"))
        v.post.append((pred, "xcomp"))
    else:
        pp_on(v, rng.choice(["in", "with", "by"]),
              NP(noun(rng.choice(MASS)), d=None), "obl")
    subj.post.append((v, "relcl"))
    return subj


def t_stacked_acl(rng: random.Random) -> N:
    """two participial modifiers on one subject ('a woman wearing a net
    cutting a cake')."""
    subj = _pick_np(rng, [PEOPLE])
    v1 = vbg(rng.choice(V_TRANS))
    v1.post.append((_pick_np(rng, [THINGS]), "obj"))
    v2 = vbg(rng.choice(V_TRANS))
    v2.post.append((_pick_np(rng, [THINGS]), "obj"))
    subj.post.append((v1, "acl"))
    subj.post.append((v2, "acl"))
    return subj


def t_vp_coord_trans(rng: random.Random) -> N:
    """'a child holding an umbrella and petting a yak' — both conjuncts
    transitive."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v1 = vbg(rng.choice(V_TRANS))
    v1.post.append((_pick_np(rng, [THINGS]), "obj"))
    v2 = vbg(rng.choice(V_TRANS))
    v2.pre.append((N("and", "CC"), "cc"))
    v2.post.append((_pick_np(rng, [THINGS, ANIMALS]), "obj"))
    v1.post.append((v2, "conj"))
    subj.post.append((v1, "acl"))
    return subj


def t_finite_poss_obj(rng: random.Random) -> N:
    """'a woman walks her dog while talking on a phone'."""
    subj = _pick_np(rng, [PEOPLE])
    v = vbz(rng.choice(V_TRANS))
    v.pre.append((subj, "nsubj"))
    obj = NP(noun(rng.choice(ANIMALS + THINGS)[0]), d=None)
    obj.pre.insert(0, (N(rng.choice(["her", "his", "their"]), "PRP$"),
                       "poss"))
    v.post.append((obj, "obj"))
    if rng.random() < 0.5:
        v2 = vbg(rng.choice(V_INTRANS))
        v2.pre.append((N("while", "IN"), "mark"))
        pp_on(v2, rng.choice(PREPS), _pick_np(rng, [THINGS]), "obl")
        v.post.append((v2, "advcl"))
    return v


def t_bare_mass_obj_nmod(rng: random.Random) -> N:
    """'a giraffe eating food from the top of the tree' — determinerless
    mass object with a PP chain."""
    subj = _pick_np(rng, [ANIMALS, PEOPLE])
    v = vbg(rng.choice(V_TRANS[:12]))
    obj = NP(noun(rng.choice(MASS)), d=None)
    mid = _pick_np(rng, [THINGS, PLACES])
    pp_on(obj, rng.choice(["from", "on", "in"]), mid, "nmod")
    if rng.random() < 0.5:
        pp_on(mid, "of", _pick_np(rng, [THINGS, PLACES]), "nmod")
    v.post.append((obj, "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_obl_conj(rng: random.Random) -> N:
    """'a pizza topped with mushrooms and olives' — coordinated obl."""
    subj = _pick_np(rng, [THINGS])
    v = N(rng.choice(PARTICIPLES[:10]), "VBN")
    a = NP(noun(rng.choice(THINGS)[1], True), d=None)
    b = NP(noun(rng.choice(THINGS)[1], True), d=None)
    b.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    pp_on(v, "with", a, "obl")
    subj.post.append((v, "acl"))
    return subj


BODY = ["head", "hand", "arm", "leg", "face", "hair", "shoulder", "neck",
        "back", "knee", "foot", "ear", "nose", "paw", "wing", "tail"]


def t_poss_body_nmod(rng: random.Random) -> N:
    """'a woman wearing a net on her head' — PRP$ + body noun inside a PP."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbg(rng.choice(V_TRANS))
    obj = _pick_np(rng, [THINGS], adj_p=0.2)
    body = NP(noun(rng.choice(BODY)), d=None)
    body.pre.insert(0, (N(rng.choice(["her", "his", "its"]), "PRP$"),
                        "poss"))
    pp_on(obj, rng.choice(["on", "in", "over", "around"]), body, "nmod")
    v.post.append((obj, "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_vp_coord_intrans(rng: random.Random) -> N:
    """'a man standing and waving' — both conjuncts intransitive."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v1 = vbg(rng.choice(V_INTRANS))
    v2 = vbg(rng.choice(V_INTRANS))
    v2.pre.append((N("and", "CC"), "cc"))
    v1.post.append((v2, "conj"))
    subj.post.append((v1, "acl"))
    return subj


def t_double_decker(rng: random.Random) -> N:
    """'a double decker bus driving down a city street'."""
    host = NP(noun("bus"), d="a", adjs=["double"], comps=["decker"])
    if rng.random() < 0.3:
        host.pre.insert(1, (N("red", "JJ"), "amod"))
    if rng.random() < 0.7:
        v = vbg(rng.choice([("drives", "driving"), ("travels", "traveling"),
                            ("parked", "parked")]))
        if v.word == "parked":
            v.tag = "VBN"
        pp_on(v, rng.choice(["down", "along", "on", "next to"]),
              _pick_np(rng, [PLACES]), "obl")
        host.post.append((v, "acl"))
    return host


def t_cop_pp_complex(rng: random.Random) -> N:
    """'a man in a red shirt and a red hat is on a motorcycle' — subject
    carries a coordinated PP, predicate is a copular PP."""
    subj = _pick_np(rng, [PEOPLE], adj_p=0.2)
    a = _pick_np(rng, [THINGS])
    if rng.random() < 0.6:
        b = _pick_np(rng, [THINGS])
        b.pre.insert(0, (N("and", "CC"), "cc"))
        a.post.append((b, "conj"))
    pp_on(subj, rng.choice(["in", "with"]), a, "nmod")
    pred = _pick_np(rng, [THINGS, PLACES])
    with_case(pred, rng.choice(["on", "in", "at", "near"]))
    pred.pre.insert(0, (N("is", "VBZ"), "cop"))
    pred.pre.insert(0, (subj, "nsubj"))
    if rng.random() < 0.4:
        pp_on(pred, rng.choice(PREPS), _pick_np(rng, [PLACES]), "nmod")
    return pred


def t_one_num(rng: random.Random) -> N:
    """'a man stands on one foot' — singular nummod."""
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbz(rng.choice(V_INTRANS))
    v.pre.append((subj, "nsubj"))
    obl = NP(noun(rng.choice(["foot", "leg", "hand", "knee", "wheel",
                              "side"])), d=None, num="one")
    pp_on(v, "on", obl, "obl")
    return v


def t_obj_coord(rng: random.Random) -> N:
    subj = _pick_np(rng, [PEOPLE, ANIMALS])
    v = vbg(rng.choice(V_TRANS))
    a = _pick_np(rng, [THINGS])
    b = _pick_np(rng, [THINGS])
    b.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    v.post.append((a, "obj"))
    subj.post.append((v, "acl"))
    return subj


def t_passive_acl_then_finite(rng: random.Random) -> N:
    """'a table covered with plates stands in a kitchen' — reduced
    relative on the subject, then a finite main verb (corpus-6 round-5
    failure class: 'filled with people floats' parsed as relcl soup)."""
    subj = _pick_np(rng, [THINGS, PLACES])
    part = N(rng.choice(PARTICIPLES), "VBN")
    pp_on(part, rng.choice(["with", "in", "by"]),
          _pick_np(rng, [THINGS, ANIMALS], plural_p=0.7), "obl")
    subj.post.append((part, "acl"))
    forms = rng.choice(V_INTRANS)
    v = vbz(forms)
    v.pre.append((subj, "nsubj"))
    prep = rng.choice(PREPS + ["down", "up", "along"])
    pp_on(v, prep, _pick_np(rng, [PLACES]), "obl")
    return v


def t_of_content_finite(rng: random.Random) -> N:
    """'a group of children play a game in a park' — of-chain subject with
    a finite plural-agreement verb (base form, pinned VB): the content noun
    acts, the object keeps its nearest-NP PP."""
    c, of = rng.choice(CONTAINERS[:8])
    host = NP(noun(c), d="a")
    sg, pl = rng.choice(rng.choice([PEOPLE, ANIMALS]))
    inner = NP(noun(pl, True), d=None)
    pp_on(host, of, inner, "nmod")
    forms = rng.choice(V_TRANS)
    v = N(forms[4], "VB")
    v.pre.append((host, "nsubj"))
    obj = _pick_np(rng, [THINGS, ANIMALS], plural_p=0.5)
    if rng.random() < 0.7:
        pp_on(obj, rng.choice(PREPS + ["along", "down"]),
              _pick_np(rng, [PLACES]), "nmod")
    v.post.append((obj, "obj"))
    return v


def t_vbn_particle(rng: random.Random) -> N:
    """'boats lined up along a canal' — VBN + RP particle + oblique
    (teaches 'up' as a particle after participles)."""
    subj = _pick_np(rng, [THINGS], plural_p=0.6)
    part = N(rng.choice(["lined", "stacked", "piled", "tied", "propped",
                         "hung", "backed", "parked"]), "VBN")
    part.post.append((N("up", "RP"), "prt"))
    pp_on(part, rng.choice(["along", "against", "at", "near", "behind",
                            "beside", "on"]),
          _pick_np(rng, [PLACES, THINGS]), "obl")
    subj.post.append((part, "acl"))
    return subj


def t_vbn_to_obl_chain(rng: random.Random) -> N:
    """'a sign attached to the front of a store' — VBN + to-oblique whose
    noun carries an of-chain (nearest-NP)."""
    subj = _pick_np(rng, [THINGS])
    part = N(rng.choice(["attached", "mounted", "fastened", "fixed",
                         "bolted", "taped", "nailed"]), "VBN")
    mid = NP(noun(rng.choice(["front", "back", "side", "top", "bottom",
                              "edge", "corner"])), d="the")
    mid.pre.insert(0, (N("to", "TO"), "case"))
    part.post.append((mid, "obl"))
    pp_on(mid, "of", _pick_np(rng, [THINGS, PLACES]), "nmod")
    subj.post.append((part, "acl"))
    return subj


def t_depictive_pp(rng: random.Random) -> N:
    """'a flag flying high above the rooftops' — post-verbal depictive JJ
    HEADS its PP (projective); the scene rules re-attach the PP per the
    nearest-NP convention."""
    subj = _pick_np(rng, [THINGS, ANIMALS])
    forms = rng.choice([("flies", "flying"), ("soars", "soaring"),
                        ("hangs", "hanging"), ("rises", "rising"),
                        ("floats", "floating"), ("glides", "gliding")])
    v = vbg(forms) if rng.random() < 0.5 else vbz(forms)
    adj = N(rng.choice(["high", "low"]), "JJ")
    pp_on(adj, rng.choice(["above", "over", "in", "behind"]),
          _pick_np(rng, [PLACES, THINGS]), "obl")
    v.post.append((adj, "advmod"))
    if v.tag == "VBG":
        subj.post.append((v, "acl"))
        return subj
    v.pre.insert(0, (subj, "nsubj"))
    return v


def t_obj_depictive_pp(rng: random.Random) -> N:
    """'a boy flying a kite high in the sky' — object, then a depictive JJ
    heading the locative PP."""
    subj = _pick_np(rng, [PEOPLE])
    v = vbg(rng.choice([("flies", "flying"), ("holds", "holding"),
                        ("lifts", "lifting"), ("raises", "raising")]))
    v.post.append((_pick_np(rng, [THINGS]), "obj"))
    adj = N(rng.choice(["high", "low"]), "JJ")
    pp_on(adj, rng.choice(["in", "above", "over"]),
          _pick_np(rng, [PLACES]), "obl")
    v.post.append((adj, "advmod"))
    subj.post.append((v, "acl"))
    return subj


def t_quant_plural(rng: random.Random) -> N:
    """'several sheep graze in a field' — DT quantifier + plural noun
    (incl. invariant plurals) + finite clause; also 'many people' objects."""
    q = rng.choice(["several", "many", "few", "some"])
    sg, pl = rng.choice(rng.choice([ANIMALS, PEOPLE, THINGS]))
    subj = NP(noun(pl, True), d=None)
    subj.pre.insert(0, (N(q, "DT"), "det"))
    forms = rng.choice(V_INTRANS)
    v = vbg(forms)
    pp_on(v, rng.choice(PREPS), _pick_np(rng, [PLACES, THINGS]), "obl")
    if rng.random() < 0.5:
        # finite: 'several sheep are standing in a field'
        v.pre.insert(0, (N("are", "VBP"), "aux"))
        v.pre.insert(0, (subj, "nsubj"))
        return v
    # caption fragment: 'several sheep grazing in a field'
    subj.post.append((v, "acl"))
    return subj


def t_obl_conj_rich(rng: random.Random) -> N:
    """'a sandwich topped with lettuce and ripe tomatoes' — VBN oblique
    coordination mixing mass nouns and modified plurals."""
    subj = _pick_np(rng, [THINGS])
    v = N(rng.choice(PARTICIPLES[:12]), "VBN")
    first_mass = rng.random() < 0.5
    a = (NP(noun(rng.choice(MASS)), d=None) if first_mass
         else NP(noun(rng.choice(THINGS)[1], True), d=None))
    b = NP(noun(rng.choice(THINGS)[1], True), d=None,
           adjs=[rng.choice(ADJS)] if rng.random() < 0.7 else [])
    b.pre.insert(0, (N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    pp_on(v, "with", a, "obl")
    subj.post.append((v, "acl"))
    return subj


def t_acl_obl_then_passive(rng: random.Random) -> N:
    """'a dog lying on a blanket covered with leaves' — the VBN modifies
    the OBLIQUE noun (nearest-NP), not the subject."""
    subj = _pick_np(rng, [ANIMALS, PEOPLE])
    v = vbg(rng.choice(V_INTRANS))
    place = _pick_np(rng, [THINGS, PLACES])
    pp_on(v, rng.choice(["on", "in", "beside", "near"]), place, "obl")
    part = N(rng.choice(PARTICIPLES), "VBN")
    pp_on(part, rng.choice(["with", "in"]),
          NP(noun(rng.choice(MASS)), d=None), "obl")
    place.post.append((part, "acl"))
    subj.post.append((v, "acl"))
    return subj


def t_amod_coord(rng: random.Random) -> N:
    host = _pick_np(rng, [THINGS, PLACES], adj_p=0.0)
    a = N(rng.choice(ADJS[:11]), "JJ")
    b = N(rng.choice(ADJS[:11]), "JJ")
    b.pre.append((N("and", "CC"), "cc"))
    a.post.append((b, "conj"))
    host.pre.append((a, "amod"))
    host.pre.sort(key=lambda cl: {"case": 0, "det": 1, "nummod": 2,
                                  "amod": 3, "compound": 4}.get(cl[1], 9))
    return host


TEMPLATES = [
    (t_bare_np, 36),
    (t_np_pp, 80),
    (t_np_pp_chain, 40),
    (t_of_np, 44),
    (t_of_np_content_acts, 40),
    (t_of_np_container_locates, 30),
    (t_acl_obj, 80),
    (t_acl_obl, 60),
    (t_acl_obj_nmod, 50),
    (t_np_pp_acl_high, 40),
    (t_relcl, 28),
    (t_relcl_aux_vbg, 20),
    (t_relcl_cop_adj, 24),
    (t_relcl_cop_pp, 32),
    (t_cop_adj, 24),
    (t_cop_adj_conj, 16),
    (t_cop_pp, 20),
    (t_finite_trans, 44),
    (t_finite_trans_aux, 20),
    (t_finite_obl, 50),
    (t_finite_intrans, 24),
    (t_subj_coord, 40),
    (t_with_coord, 24),
    (t_asyndetic_list, 16),
    (t_poss, 20),
    (t_there_is, 24),
    (t_passive_acl, 40),
    (t_passive_cop, 24),
    (t_vp_coord, 24),
    (t_while_advcl, 20),
    (t_as_pronoun_advcl, 20),
    (t_control, 24),
    (t_raising, 16),
    (t_getting_ready, 12),
    (t_particle, 20),
    (t_close_up, 12),
    (t_each_other, 12),
    (t_depictive, 12),
    (t_advmod_adj, 16),
    (t_attrib_participle, 20),
    (t_compound, 28),
    (t_triple_compound, 16),
    (t_nn_vb_ambig, 48),
    (t_postposed_adj, 20),
    (t_acl_then_finite, 20),
    (t_cop_vp_coord, 16),
    (t_obj_coord, 20),
    (t_amod_coord, 16),
    (t_postnominal_adj_of, 20),
    (t_asyndetic_bare, 28),
    (t_obl_nmod_chain, 32),
    (t_obj_nmod_chain2, 28),
    (t_themed, 16),
    (t_relcl_passive, 24),
    (t_stacked_acl, 24),
    (t_vp_coord_trans, 28),
    (t_finite_poss_obj, 20),
    (t_bare_mass_obj_nmod, 28),
    (t_obl_conj, 20),
    (t_one_num, 12),
    (t_poss_body_nmod, 24),
    (t_vp_coord_intrans, 20),
    (t_double_decker, 12),
    (t_cop_pp_complex, 24),
    # round-5 corpus-6 failure classes (fresh instantiations only)
    (t_passive_acl_then_finite, 32),
    (t_of_content_finite, 28),
    (t_vbn_particle, 24),
    (t_vbn_to_obl_chain, 20),
    (t_depictive_pp, 20),
    (t_obj_depictive_pp, 16),
    (t_quant_plural, 24),
    (t_obl_conj_rich, 28),
    (t_acl_obl_then_passive, 20),
]

OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "caption_treebank.txt")


def build_lexicon() -> dict:
    """word -> tag for open-class words that are UNAMBIGUOUS across every
    lexicon pool above (the tagger pins these; anything appearing in two
    pools with different tags — "waves" NNS/VBZ, "light" JJ/NN — is left
    to the model)."""
    by_word: dict = {}

    def add(w: str, t: str) -> None:
        by_word.setdefault(w, set()).add(t)

    for pool in (PEOPLE, ANIMALS, THINGS, PLACES):
        for sg, pl in pool:
            add(sg, "NN")
            add(pl, "NNS")
    for c, _of in CONTAINERS:
        add(c, "NN")
    for w in MASS:
        add(w, "NN")
    for w in BODY:
        add(w, "NN")
    for mod, head in COMPOUND_PAIRS:
        add(mod, "JJ" if mod == "flat" else "NN")
        add(head, "NN")
    for w in ADJS:
        add(w, "JJ")
    for w in PARTICIPLES:
        add(w, "VBN")
    for forms in V_TRANS:
        for f, t in zip(forms, ("VBZ", "VBG", "VBD", "VBN", "VB")):
            add(f, t)
    for z, g in V_INTRANS:
        add(z, "VBZ")
        add(g, "VBG")
    # VBD/VBN collisions are fine to pin as VBN: both are past forms and
    # the scene rules treat them identically
    out = {}
    for w, tags in by_word.items():
        if len(tags) == 1:
            out[w] = next(iter(tags))
        elif tags == {"VBD", "VBN"}:
            out[w] = "VBN"
    return out


def generate(seed: int = 20260819) -> List[List[Tuple[str, str, int, str]]]:
    rng = random.Random(seed)
    out = []
    seen = set()
    for fn, k in TEMPLATES:
        made = 0
        attempts = 0
        while made < k and attempts < k * 30:
            attempts += 1
            rows = fn(rng).flatten()
            key = tuple(r[0] for r in rows)
            if key in seen:
                continue
            seen.add(key)
            out.append(rows)
            made += 1
    return out


def main() -> None:
    sentences = generate()
    with open(OUT_PATH, "w") as fh:
        fh.write("# caption_treebank.txt — generated by gen_treebank.py; "
                 "do not edit by hand\n")
        for rows in sentences:
            fh.write("# text = " + " ".join(r[0] for r in rows) + "\n")
            for i, (w, t, h, l) in enumerate(rows, start=1):
                fh.write(f"{i}\t{w}\t{t}\t{h}\t{l}\n")
            fh.write("\n")
    print(f"wrote {len(sentences)} sentences to {OUT_PATH}")


if __name__ == "__main__":
    main()
