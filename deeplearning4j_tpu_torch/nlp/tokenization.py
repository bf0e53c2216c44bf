"""Tokenizers + factories + preprocessors.

Mirror of reference nlp text/tokenization/** (DefaultTokenizer,
NGramTokenizer, PosUimaTokenizer, factories, CommonPreprocessor/
EndingPreProcessor). The reference's UIMA-backed tokenizers ride a
ClearTK POS-tagger pipeline; UIMA is a JVM-only stack, so the
POS-filtered tokenizer here uses a self-contained rule tagger with the
same observable contract: tokens whose POS is outside the allowed set
collapse to a placeholder.

A copy of ``deeplearning4j_tpu/nlp/tokenization.py`` (pure Python).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation (reference CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer from the reference (strips common English endings)."""

    def pre_process(self, token: str) -> str:
        for ending in ("ing", "ed", "es", "s", "ly"):
            if token.endswith(ending) and len(token) > len(ending) + 2:
                return token[: -len(ending)]
        return token


class Tokenizer:
    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            p = self._pre.pre_process(t)
            if p:
                out.append(p)
        return out

    def count_tokens(self) -> int:
        return len(self._tokens)


class TokenizerFactory:
    def __init__(self):
        self.preprocessor: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self.preprocessor = pre

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenization (reference DefaultTokenizer wraps
    StringTokenizer)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self.preprocessor)


class RuleBasedPosTagger:
    """Tiny deterministic POS tagger (closed-class lexicon + suffix
    rules). Stands in for the reference's UIMA/ClearTK tagger behind
    PosUimaTokenizer (text/tokenization/tokenizer/PosUimaTokenizer.java);
    intentionally coarse — callers only branch on the tag class. For a
    TRAINABLE statistical tagger with the same ``tag`` interface plus
    contextual ``tag_sequence``, use nlp/pos.py HmmPosTagger."""

    _DETERMINERS = {"the", "a", "an", "this", "that", "these", "those"}
    _PRONOUNS = {"i", "you", "he", "she", "it", "we", "they", "me",
                 "him", "her", "us", "them", "its", "his", "their", "my",
                 "your", "our"}
    _PREPOSITIONS = {"in", "on", "at", "by", "for", "with", "about",
                     "against", "between", "into", "through", "during",
                     "of", "to", "from", "up", "down", "over", "under"}
    _CONJUNCTIONS = {"and", "or", "but", "nor", "so", "yet", "because",
                     "although", "while", "if"}
    _MODALS = {"can", "could", "will", "would", "shall", "should", "may",
               "might", "must"}
    _BE_VERBS = {"is", "am", "are", "was", "were", "be", "been", "being",
                 "has", "have", "had", "do", "does", "did"}
    _COMMON_VERBS = {"run", "runs", "ran", "go", "goes", "went", "sleep",
                     "sleeps", "sit", "sits", "sat", "eat", "eats", "ate",
                     "jump", "jumps", "bark", "barks", "say", "says",
                     "said", "make", "makes", "made", "take", "takes",
                     "took", "see", "sees", "saw", "come", "comes",
                     "came", "get", "gets", "got", "know", "knows",
                     "knew", "think", "thinks", "look", "looks", "want",
                     "wants", "give", "gives", "gave", "find", "finds",
                     "found", "tell", "tells", "told", "work", "works",
                     "seem", "seems", "feel", "feels", "felt", "leave",
                     "leaves", "left", "keep", "keeps", "kept", "let",
                     "lets", "begin", "begins", "began", "show", "shows",
                     "hear", "hears", "heard", "play", "plays", "move",
                     "moves", "like", "likes", "live", "lives", "hold",
                     "holds", "held", "write", "writes", "wrote", "read",
                     "reads", "speak", "speaks", "spoke", "grow", "grows",
                     "grew", "walk", "walks", "win", "wins", "won",
                     "love", "loves", "hate", "hates", "buy", "buys",
                     "bought", "build", "builds", "built", "fall",
                     "falls", "fell"}
    _COMMON_ADVERBS = {"fast", "very", "quite", "too", "also", "now",
                       "then", "here", "there", "well", "often", "never",
                       "always", "soon", "again", "still", "just", "not"}

    def tag(self, token: str) -> str:
        w = token.lower()
        if not w:
            return "NONE"
        if w in self._DETERMINERS:
            return "DT"
        if w in self._PRONOUNS:
            return "PRP"
        if w in self._PREPOSITIONS:
            return "IN"
        if w in self._CONJUNCTIONS:
            return "CC"
        if w in self._MODALS:
            return "MD"
        if w in self._BE_VERBS or w in self._COMMON_VERBS:
            return "VB"
        if w[0].isdigit():
            return "CD"
        if w.endswith("ly") or w in self._COMMON_ADVERBS:
            return "RB"
        if w.endswith(("ing", "ed")) and len(w) > 4:
            return "VB"
        if w.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
            return "JJ"
        return "NN"


class PosTokenizerFactory(TokenizerFactory):
    """Keeps tokens whose POS tag is in ``allowed_pos``; others become
    a placeholder so window offsets are preserved — the reference
    PosUimaTokenizer's behavior for its moving-window features."""

    PLACEHOLDER = "NONE"

    def __init__(self, allowed_pos: List[str],
                 tagger: Optional[RuleBasedPosTagger] = None):
        super().__init__()
        self.allowed_pos = set(allowed_pos)
        self.tagger = tagger or RuleBasedPosTagger()

    def create(self, text: str) -> Tokenizer:
        # Preprocess/tag first; placeholders are exempt from further
        # preprocessing so window offsets survive intact (a preprocessed
        # token that becomes empty also collapses to the placeholder
        # rather than being dropped).
        kept = []
        for w in text.split():
            token = (self.preprocessor.pre_process(w)
                     if self.preprocessor else w)
            if token and self.tagger.tag(token) in self.allowed_pos:
                kept.append(token)
            else:
                kept.append(self.PLACEHOLDER)
        return Tokenizer(kept, None)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams over the base tokenization (reference NGramTokenizer)."""

    def __init__(self, n_min: int = 1, n_max: int = 2):
        super().__init__()
        self.n_min = n_min
        self.n_max = n_max

    def create(self, text: str) -> Tokenizer:
        words = text.split()
        grams: List[str] = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i : i + n]))
        return Tokenizer(grams, self.preprocessor)
