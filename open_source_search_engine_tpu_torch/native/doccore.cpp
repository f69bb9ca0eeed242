// Native document core: HTML tokenize + term hash + rank columns.
//
// The reference's build plane is C++ (XmlDoc::hashAll, XmlDoc.cpp:28957;
// Xml.cpp/Words.cpp/Pos.cpp tokenization), and so is this package's
// host build plane: this file is a copy of the JAX package's
// native/doccore.cpp, carried so that the port builds from its own
// sources. It reproduces the
// semantics of build/tokenizer.py (_HtmlTok) and the hashing/rank layer
// of build/docproc.py — bit-exactly for ASCII documents, and with a
// documented approximation of Python's \w and str.lower() for non-ASCII
// codepoints (common Latin/Greek/Cyrillic/CJK ranges are classified;
// exotic scripts fall back to "not a word char").
//
// Everything returns as columnar arrays in one malloc'd arena so the
// Python side does a handful of ctypes reads + one vectorized key pack
// per document instead of 10^5 interpreter ops.
//
// Build: g++ -O2 -shared -fPIC doccore.cpp -o libdoccore_<hash>.so
// (driven by native/__init__.py into build/torch_native/)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <strings.h>
#include <string>
#include <vector>
#include <unordered_map>

// ---------------------------------------------------------------- hashing
// ghash.hash64 for short payloads: FNV-1a 64 + murmur finalizer.
static inline uint64_t fnv_avalanche(const char* data, size_t len,
                                     uint64_t seed) {
    uint64_t h = 0xCBF29CE484222325ULL ^ seed;
    for (size_t i = 0; i < len; i++) {
        h ^= (uint8_t)data[i];
        h *= 0x100000001B3ULL;
    }
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDULL;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ULL;
    h ^= h >> 33;
    return h;
}

static const uint64_t TERMID_MASK = (1ULL << 48) - 1;

// ---------------------------------------------------------------- unicode
// Decode one UTF-8 codepoint at p (len remaining); returns codepoint and
// advances *adv. Invalid bytes decode as themselves (latin-1 style).
static inline uint32_t u8_decode(const char* p, size_t len, int* adv) {
    uint8_t b0 = (uint8_t)p[0];
    if (b0 < 0x80) { *adv = 1; return b0; }
    if ((b0 >> 5) == 0x6 && len >= 2 && ((uint8_t)p[1] >> 6) == 0x2) {
        *adv = 2; return ((b0 & 0x1F) << 6) | ((uint8_t)p[1] & 0x3F);
    }
    if ((b0 >> 4) == 0xE && len >= 3 && ((uint8_t)p[1] >> 6) == 0x2 &&
        ((uint8_t)p[2] >> 6) == 0x2) {
        *adv = 3;
        return ((b0 & 0x0F) << 12) | (((uint8_t)p[1] & 0x3F) << 6) |
               ((uint8_t)p[2] & 0x3F);
    }
    if ((b0 >> 3) == 0x1E && len >= 4 && ((uint8_t)p[1] >> 6) == 0x2 &&
        ((uint8_t)p[2] >> 6) == 0x2 && ((uint8_t)p[3] >> 6) == 0x2) {
        *adv = 4;
        return ((b0 & 0x07) << 18) | (((uint8_t)p[1] & 0x3F) << 12) |
               (((uint8_t)p[2] & 0x3F) << 6) | ((uint8_t)p[3] & 0x3F);
    }
    *adv = 1; return b0;  // stray byte
}

static inline int u8_encode(uint32_t cp, char* out) {
    if (cp < 0x80) { out[0] = (char)cp; return 1; }
    if (cp < 0x800) {
        out[0] = (char)(0xC0 | (cp >> 6));
        out[1] = (char)(0x80 | (cp & 0x3F)); return 2;
    }
    if (cp < 0x10000) {
        out[0] = (char)(0xE0 | (cp >> 12));
        out[1] = (char)(0x80 | ((cp >> 6) & 0x3F));
        out[2] = (char)(0x80 | (cp & 0x3F)); return 3;
    }
    out[0] = (char)(0xF0 | (cp >> 18));
    out[1] = (char)(0x80 | ((cp >> 12) & 0x3F));
    out[2] = (char)(0x80 | ((cp >> 6) & 0x3F));
    out[3] = (char)(0x80 | (cp & 0x3F)); return 4;
}

// Python \w approximation (see file header).
static inline bool is_word_cp(uint32_t cp) {
    if (cp < 0x80)
        return (cp >= '0' && cp <= '9') || (cp >= 'a' && cp <= 'z') ||
               (cp >= 'A' && cp <= 'Z') || cp == '_';
    if (cp >= 0xC0 && cp <= 0x24F) return cp != 0xD7 && cp != 0xF7;
    if (cp >= 0x386 && cp <= 0x3FF) return cp != 0x387;
    if (cp >= 0x400 && cp <= 0x4FF) return true;   // Cyrillic
    if (cp >= 0x531 && cp <= 0x586) return true;   // Armenian
    if (cp >= 0x5D0 && cp <= 0x5EA) return true;   // Hebrew
    if ((cp >= 0x620 && cp <= 0x64A) || (cp >= 0x660 && cp <= 0x669) ||
        (cp >= 0x66E && cp <= 0x6FF)) return true; // Arabic
    if (cp >= 0x900 && cp <= 0x97F) return cp != 0x964 && cp != 0x965;
    if (cp >= 0x3040 && cp <= 0x30FF) return true; // kana
    if (cp >= 0x4E00 && cp <= 0x9FFF) return true; // CJK
    if (cp >= 0xAC00 && cp <= 0xD7A3) return true; // Hangul
    return false;
}

// str.lower() approximation for the ranges above.
static inline uint32_t lower_cp(uint32_t cp) {
    if (cp < 0x80) return (cp >= 'A' && cp <= 'Z') ? cp + 0x20 : cp;
    if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 0x20;
    if (cp >= 0x100 && cp <= 0x137) return (cp & 1) ? cp : cp + 1;
    if (cp >= 0x139 && cp <= 0x148) return (cp & 1) ? cp + 1 : cp;
    if (cp >= 0x14A && cp <= 0x177) return (cp & 1) ? cp : cp + 1;
    if (cp >= 0x179 && cp <= 0x17E) return (cp & 1) ? cp + 1 : cp;
    if (cp >= 0x391 && cp <= 0x3A9 && cp != 0x3A2) return cp + 0x20;
    if (cp >= 0x410 && cp <= 0x42F) return cp + 0x20;
    if (cp >= 0x400 && cp <= 0x40F) return cp + 0x50;
    return cp;
}

// ------------------------------------------------------------- constants
// Mirrors of tokenizer.py / posdb.py values.
enum {
    HG_BODY = 0, HG_TITLE = 1, HG_HEADING = 2, HG_INLIST = 3,
    HG_INMETATAG = 4, HG_INLINKTEXT = 5, HG_INTAG = 6,
    HG_INURL = 9, HG_INMENU = 10,
};
static const int SENT_GAP = 2;
static const int BLOCK_GAP = 4;
static const int32_t MAXWORDPOS = 0x3FFFF;
static const int MAXDENSITYRANK = 31;
static const int MAXWORDSPAMRANK = 15;

static bool in_set(const char* tag, const char* const* set) {
    for (int i = 0; set[i]; i++)
        if (!strcmp(tag, set[i])) return true;
    return false;
}

static const char* const HEADING_TAGS[] = {"h1","h2","h3","h4","h5","h6",0};
static const char* const SKIP_TAGS[] = {"script","style","noscript",
                                        "template","svg",0};
static const char* const LIST_TAGS[] = {"li","dd","dt",0};
static const char* const MENU_TAGS[] = {"nav","menu",0};
static const char* const BLOCK_TAGS[] = {
    "p","div","br","tr","td","table","ul","ol","section","article",
    "header","footer","blockquote","pre","h1","h2","h3","h4","h5","h6",
    "li","title",0};
static const char* const SECTION_TAGS[] = {
    "div","section","article","header","footer","aside","nav","menu",
    "table","ul","ol","dl","form","blockquote","p","li","tr","td","th",
    "dd","dt","pre","h1","h2","h3","h4","h5","h6",0};

// ------------------------------------------------------------ result ABI
extern "C" {
typedef struct {
    // word-token columns (doc words + url words)
    int64_t n;
    uint64_t* termid;
    int32_t*  wordpos;
    uint8_t*  hashgroup;
    uint8_t*  density;
    uint8_t*  spam;
    int32_t*  sentence;
    uint64_t* sect;      // per-token section path hash (0 = none)
    // bigram tokens: termid + index of the first word
    int64_t nb;
    uint64_t* b_termid;
    int32_t*  b_src;
    // lowercased words, '\n'-joined (for speller/langid)
    char* words_buf;   int64_t words_len;
    // visible text (whitespace-normalized), title, meta desc/date
    char* text_buf;    int64_t text_len;
    char* title_buf;   int64_t title_len;
    char* desc_buf;    int64_t desc_len;
    char* date_buf;    int64_t date_len;
    // links: href '\x1f' anchor, records '\x1e'-joined
    char* links_buf;   int64_t links_len;
    // sections: path hash + '\x1e'-joined per-section word content
    int64_t nsect;
    uint64_t* sect_hash;
    int32_t*  sect_words;   // word count per section
    char* sect_buf;    int64_t sect_len;
    // 1 = exotic entity seen: caller must rerun via the Python path
    // (full HTML5 charref table) to keep bit-identical output
    int32_t fallback;
} osse_doc;
}

// ------------------------------------------------------------- tokenizer
namespace {

struct Tok {
    std::string word;      // lowercased
    int32_t pos;
    uint8_t hg;
    int32_t sent;
    uint64_t sect;
};

struct SectFrame {
    std::string tag;
    uint64_t hash;
    std::unordered_map<std::string, int> counters;
};

struct Parser {
    std::vector<Tok> toks;
    std::string title, desc, date, text;
    std::vector<std::pair<std::string, std::string>> links;
    int32_t pos = 0;
    int32_t sent = 0;
    int skip_depth = 0, title_depth = 0, heading_depth = 0;
    int list_depth = 0, menu_depth = 0;
    bool fallback = false;  // exotic entity seen → punt to Python path
    bool in_anchor = false;
    std::string anchor_href, anchor_words;
    std::vector<SectFrame> sect_stack;
    std::unordered_map<std::string, int> root_ordinals;

    uint64_t section_id() const {
        if (sect_stack.empty()) return 0;
        size_t i = sect_stack.size() > 1 ? 1 : 0;
        return sect_stack[i].hash;
    }

    void sect_push(const std::string& tag) {
        uint64_t parent = 0;
        std::unordered_map<std::string, int>* counters = &root_ordinals;
        if (!sect_stack.empty()) {
            parent = sect_stack.back().hash;
            counters = &sect_stack.back().counters;
        }
        int ordinal = (*counters)[tag]++;
        // _sect_hash: hash64(f"{parent_hash}:{tag}:{ordinal}")
        char buf[96];
        int n = snprintf(buf, sizeof buf, "%llu:%s:%d",
                         (unsigned long long)parent, tag.c_str(), ordinal);
        sect_stack.push_back({tag, fnv_avalanche(buf, (size_t)n, 0), {}});
    }

    void sect_pop(const std::string& tag) {
        for (int i = (int)sect_stack.size() - 1; i >= 0; i--)
            if (sect_stack[i].tag == tag) {
                sect_stack.resize(i);
                return;
            }
    }

    // word scan of a byte range: callback per word (lowercased utf-8)
    template <class F>
    void scan_words(const char* s, size_t len, F&& emit) {
        std::string w;
        size_t i = 0;
        while (i < len) {
            int adv;
            uint32_t cp = u8_decode(s + i, len - i, &adv);
            if (is_word_cp(cp)) {
                char enc[4];
                int m = u8_encode(lower_cp(cp), enc);
                w.append(enc, m);
            } else if (!w.empty()) {
                emit(w);
                w.clear();
            }
            i += adv;
        }
        if (!w.empty()) emit(w);
    }

    // _emit_words: sentence-split + word scan with Pos.cpp advance
    void emit_words(const char* s, size_t len, uint8_t hg) {
        uint64_t sid = section_id();
        size_t i = 0;
        bool last_chunk_done = false;
        while (!last_chunk_done) {
            // chunk = up to the next run of [.!?;:]
            size_t j = i;
            while (j < len) {
                char c = s[j];
                if (c == '.' || c == '!' || c == '?' || c == ';' ||
                    c == ':')
                    break;
                j++;
            }
            // words of the chunk
            bool any = false;
            int32_t p = pos;
            scan_words(s + i, j - i, [&](const std::string& w) {
                toks.push_back({w, p < MAXWORDPOS ? p : MAXWORDPOS, hg,
                                sent, sid});
                p++;
                any = true;
            });
            if (any) pos = p;
            if (j >= len) last_chunk_done = true;
            else {
                // swallow the punctuation run
                while (j < len && (s[j] == '.' || s[j] == '!' ||
                                   s[j] == '?' || s[j] == ';' ||
                                   s[j] == ':'))
                    j++;
                if (j >= len) {
                    // trailing punctuation: one final empty chunk
                    pos += SENT_GAP;
                    sent += 1;
                    last_chunk_done = true;
                }
            }
            if (!last_chunk_done) {
                pos += SENT_GAP;
                sent += 1;
            }
            i = j;
        }
        // python: always adds the gap per chunk then undoes the last —
        // net effect reproduced above (the final chunk adds no gap)
    }

    void handle_data(const char* s, size_t len) {
        if (skip_depth) return;
        if (title_depth) {
            title.append(s, len);
            emit_words(s, len, HG_TITLE);
            return;
        }
        uint8_t hg = HG_BODY;
        if (heading_depth) hg = HG_HEADING;
        else if (list_depth) hg = HG_INLIST;
        else if (menu_depth) hg = HG_INMENU;
        if (in_anchor) {
            scan_words(s, len, [&](const std::string& w) {
                if (!anchor_words.empty()) anchor_words += ' ';
                anchor_words += w;
            });
        }
        if (!text.empty()) text += ' ';
        text.append(s, len);
        emit_words(s, len, hg);
    }
};

// lowercase ASCII in place (tag/attr names)
static void ascii_lower(std::string& s) {
    for (char& c : s)
        if (c >= 'A' && c <= 'Z') c += 0x20;
}

// ---- HTML entity table ------------------------------------------------
// Python's convert_charrefs resolves the FULL HTML5 table; we carry the
// Latin-1 named set + the common typographic symbols and set a
// ``fallback`` flag on anything else — the caller then reruns the doc
// through the Python tokenizer, preserving the bit-identical contract
// instead of silently diverging.
struct Ent { const char* name; uint32_t cp; };
static const Ent ENTS[] = {
    {"amp",'&'},{"AMP",'&'},{"lt",'<'},{"LT",'<'},{"gt",'>'},
    {"GT",'>'},{"quot",'"'},{"QUOT",'"'},{"apos",'\''},
    {"nbsp",0xA0},{"iexcl",0xA1},{"cent",0xA2},{"pound",0xA3},
    {"curren",0xA4},{"yen",0xA5},{"brvbar",0xA6},{"sect",0xA7},
    {"uml",0xA8},{"copy",0xA9},{"COPY",0xA9},{"ordf",0xAA},
    {"laquo",0xAB},{"not",0xAC},{"shy",0xAD},{"reg",0xAE},
    {"REG",0xAE},{"macr",0xAF},{"deg",0xB0},{"plusmn",0xB1},
    {"sup2",0xB2},{"sup3",0xB3},{"acute",0xB4},{"micro",0xB5},
    {"para",0xB6},{"middot",0xB7},{"cedil",0xB8},{"sup1",0xB9},
    {"ordm",0xBA},{"raquo",0xBB},{"frac14",0xBC},{"frac12",0xBD},
    {"frac34",0xBE},{"iquest",0xBF},
    {"Agrave",0xC0},{"Aacute",0xC1},{"Acirc",0xC2},{"Atilde",0xC3},
    {"Auml",0xC4},{"Aring",0xC5},{"AElig",0xC6},{"Ccedil",0xC7},
    {"Egrave",0xC8},{"Eacute",0xC9},{"Ecirc",0xCA},{"Euml",0xCB},
    {"Igrave",0xCC},{"Iacute",0xCD},{"Icirc",0xCE},{"Iuml",0xCF},
    {"ETH",0xD0},{"Ntilde",0xD1},{"Ograve",0xD2},{"Oacute",0xD3},
    {"Ocirc",0xD4},{"Otilde",0xD5},{"Ouml",0xD6},{"times",0xD7},
    {"Oslash",0xD8},{"Ugrave",0xD9},{"Uacute",0xDA},{"Ucirc",0xDB},
    {"Uuml",0xDC},{"Yacute",0xDD},{"THORN",0xDE},{"szlig",0xDF},
    {"agrave",0xE0},{"aacute",0xE1},{"acirc",0xE2},{"atilde",0xE3},
    {"auml",0xE4},{"aring",0xE5},{"aelig",0xE6},{"ccedil",0xE7},
    {"egrave",0xE8},{"eacute",0xE9},{"ecirc",0xEA},{"euml",0xEB},
    {"igrave",0xEC},{"iacute",0xED},{"icirc",0xEE},{"iuml",0xEF},
    {"eth",0xF0},{"ntilde",0xF1},{"ograve",0xF2},{"oacute",0xF3},
    {"ocirc",0xF4},{"otilde",0xF5},{"ouml",0xF6},{"divide",0xF7},
    {"oslash",0xF8},{"ugrave",0xF9},{"uacute",0xFA},{"ucirc",0xFB},
    {"uuml",0xFC},{"yacute",0xFD},{"thorn",0xFE},{"yuml",0xFF},
    {"hellip",0x2026},{"mdash",0x2014},{"ndash",0x2013},
    {"lsquo",0x2018},{"rsquo",0x2019},{"ldquo",0x201C},
    {"rdquo",0x201D},{"bull",0x2022},{"trade",0x2122},
    {"euro",0x20AC},{"dagger",0x2020},{"Dagger",0x2021},
    {"permil",0x2030},{"prime",0x2032},{"Prime",0x2033},
    {"minus",0x2212},
    {0, 0},
};

static uint32_t ent_lookup(const std::string& name) {
    for (int k = 0; ENTS[k].name; k++)
        if (name == ENTS[k].name) return ENTS[k].cp;
    return 0;
}

// decode HTML entities (html.parser convert_charrefs). Sets *fallback
// when an entity outside our table (or a no-semicolon form Python's
// html.unescape would resolve) is seen — the caller must rerun the doc
// through the Python path for exact parity.
static std::string decode_entities(const char* s, size_t len,
                                   bool* fallback) {
    std::string out;
    out.reserve(len);
    size_t i = 0;
    while (i < len) {
        if (s[i] != '&') { out += s[i++]; continue; }
        size_t j = i + 1, end = len < i + 34 ? len : i + 34;
        bool numeric = j < end && s[j] == '#';
        while (j < end && (isalnum((uint8_t)s[j]) ||
                           (numeric && j == i + 1)))
            j++;
        bool has_semi = j < len && s[j] == ';';
        std::string ent(s + i + 1, j - i - 1);
        if (ent.empty()) { out += s[i++]; continue; }
        if (ent[0] == '#') {
            // python resolves numeric charrefs even without ';'
            bool hex =
                ent.size() > 1 && (ent[1] == 'x' || ent[1] == 'X');
            // digit-less forms (&#;, &#x;) are not charrefs — literal,
            // exactly what html.unescape's charref regex requires
            bool has_digits = hex
                ? (ent.size() > 2 && isxdigit((uint8_t)ent[2]))
                : (ent.size() > 1 && isdigit((uint8_t)ent[1]));
            if (!has_digits) { out += s[i++]; continue; }
            uint32_t cp = hex
                ? (uint32_t)strtoul(ent.c_str() + 2, 0, 16)
                : (uint32_t)strtoul(ent.c_str() + 1, 0, 10);
            // html.unescape maps NUL, surrogate code points and
            // beyond-Unicode values to U+FFFD
            if (cp == 0 || (cp >= 0xD800 && cp <= 0xDFFF)
                    || cp > 0x10FFFF)
                cp = 0xFFFD;
            char enc[4];
            out.append(enc, u8_encode(cp, enc));
            i = has_semi ? j + 1 : j;
            continue;
        }
        if (has_semi) {
            uint32_t cp = ent_lookup(ent);
            if (cp) {
                char enc[4];
                out.append(enc, u8_encode(cp, enc));
                i = j + 1;
                continue;
            }
            *fallback = true;  // unknown named entity with ';'
            out += s[i++];
            continue;
        }
        // no semicolon: html.unescape still resolves legacy names by
        // LONGEST PREFIX — any known-name prefix means divergence
        for (int k = 0; ENTS[k].name; k++)
            if (ent.compare(0, strlen(ENTS[k].name), ENTS[k].name)
                    == 0) {
                *fallback = true;
                break;
            }
        out += s[i++];
    }
    return out;
}

struct Attr { std::string name, val; };

// parse attributes between p and end (after the tag name).
// *slash_in_val is set when the byte just before '>' was consumed as
// part of an UNQUOTED attribute value (html.parser keeps it in the
// value: <a href=foo/> has value "foo/" and is NOT self-closing, while
// <a href="foo"/> and <a checked/> are) — the caller must not treat
// that trailing '/' as a self-close marker.
static void parse_attrs(const char* p, const char* end,
                        std::vector<Attr>& out, bool* fallback,
                        bool* slash_in_val) {
    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r' || *p == '/'))
            p++;
        if (p >= end) break;
        const char* ns = p;
        while (p < end && *p != '=' && *p != ' ' && *p != '\t' &&
               *p != '\n' && *p != '\r' && *p != '/')
            p++;
        std::string name(ns, p - ns);
        ascii_lower(name);
        std::string val;
        const char* q = p;
        while (q < end && (*q == ' ' || *q == '\t' || *q == '\n' ||
                           *q == '\r'))
            q++;
        if (q < end && *q == '=') {
            q++;
            while (q < end && (*q == ' ' || *q == '\t' || *q == '\n' ||
                               *q == '\r'))
                q++;
            if (q < end && (*q == '"' || *q == '\'')) {
                char quote = *q++;
                const char* vs = q;
                while (q < end && *q != quote) q++;
                val = decode_entities(vs, q - vs, fallback);
                if (q < end) q++;
            } else {
                const char* vs = q;
                while (q < end && *q != ' ' && *q != '\t' &&
                       *q != '\n' && *q != '\r')
                    q++;
                val = decode_entities(vs, q - vs, fallback);
                if (q == end && q > vs && q[-1] == '/')
                    *slash_in_val = true;
            }
            p = q;
        }
        if (!name.empty()) out.push_back({name, val});
    }
}

static void handle_starttag(Parser& P, const std::string& tag,
                            std::vector<Attr>& attrs) {
    if (in_set(tag.c_str(), SKIP_TAGS)) { P.skip_depth++; return; }
    if (P.skip_depth) return;
    if (tag == "title") P.title_depth++;
    else if (in_set(tag.c_str(), HEADING_TAGS)) P.heading_depth++;
    else if (in_set(tag.c_str(), LIST_TAGS)) P.list_depth++;
    else if (in_set(tag.c_str(), MENU_TAGS)) P.menu_depth++;
    else if (tag == "a") {
        P.in_anchor = false;
        P.anchor_href.clear();
        P.anchor_words.clear();
        for (auto& a : attrs)
            if (a.name == "href") {
                P.anchor_href = a.val;
                P.in_anchor = true;
            }
    } else if (tag == "meta") {
        // python: d = dict(attrs) (last-wins), then
        // name = d.get("name") or d.get("property")
        std::string name_attr, prop_attr, content;
        for (auto& a : attrs) {
            if (a.name == "name") name_attr = a.val;
            else if (a.name == "property") prop_attr = a.val;
            else if (a.name == "content") content = a.val;
        }
        std::string name = !name_attr.empty() ? name_attr : prop_attr;
        ascii_lower(name);
        if (!content.empty() &&
            (name == "article:published_time" || name == "date" ||
             name == "pubdate" || name == "og:published_time" ||
             name == "dc.date")) {
            if (P.date.empty()) P.date = content;
        }
        if ((name == "description" || name == "keywords") &&
            !content.empty()) {
            if (name == "description") P.desc = content;
            P.sent += 1;
            P.emit_words(content.data(), content.size(), HG_INMETATAG);
            P.sent += 1;
        }
    }
    if (in_set(tag.c_str(), SECTION_TAGS)) P.sect_push(tag);
    if (in_set(tag.c_str(), BLOCK_TAGS)) {
        P.pos += BLOCK_GAP;
        P.sent += 1;
    }
}

static void handle_endtag(Parser& P, const std::string& tag) {
    if (in_set(tag.c_str(), SKIP_TAGS)) {
        if (P.skip_depth) P.skip_depth--;
        return;
    }
    if (P.skip_depth) return;
    if (in_set(tag.c_str(), SECTION_TAGS)) P.sect_pop(tag);
    if (tag == "title") { if (P.title_depth) P.title_depth--; }
    else if (in_set(tag.c_str(), HEADING_TAGS)) {
        if (P.heading_depth) P.heading_depth--;
    } else if (in_set(tag.c_str(), LIST_TAGS)) {
        if (P.list_depth) P.list_depth--;
    } else if (in_set(tag.c_str(), MENU_TAGS)) {
        if (P.menu_depth) P.menu_depth--;
    } else if (tag == "a" && P.in_anchor) {
        P.links.push_back({P.anchor_href, P.anchor_words});
        P.in_anchor = false;
        P.anchor_href.clear();
        P.anchor_words.clear();
    }
    if (in_set(tag.c_str(), BLOCK_TAGS)) {
        P.pos += BLOCK_GAP;
        P.sent += 1;
    }
}

static void parse_html(Parser& P, const char* s, size_t len) {
    size_t i = 0;
    auto flush_text = [&](const char* ts, size_t tlen) {
        if (!tlen) return;
        if (memchr(ts, '&', tlen)) {
            std::string dec = decode_entities(ts, tlen, &P.fallback);
            P.handle_data(dec.data(), dec.size());
        } else {
            P.handle_data(ts, tlen);
        }
    };
    while (i < len) {
        const char* lt = (const char*)memchr(s + i, '<', len - i);
        if (!lt) { flush_text(s + i, len - i); break; }
        size_t ti = (size_t)(lt - s);
        flush_text(s + i, ti - i);
        i = ti;
        // stray '<' not opening a tag: html.parser emits it as data
        // and resumes at the next character
        {
            char nxt = (i + 1 < len) ? s[i + 1] : 0;
            bool tagish = (nxt >= 'a' && nxt <= 'z') ||
                          (nxt >= 'A' && nxt <= 'Z') || nxt == '/' ||
                          nxt == '!' || nxt == '?';
            if (!tagish) {
                P.handle_data("<", 1);
                i += 1;
                continue;
            }
        }
        // comment / doctype / processing instruction
        if (i + 3 < len && s[i + 1] == '!' && s[i + 2] == '-' &&
            s[i + 3] == '-') {
            const char* e = (const char*)memmem(s + i + 4, len - i - 4,
                                                "-->", 3);
            i = e ? (size_t)(e - s) + 3 : len;
            continue;
        }
        if (i + 1 < len && (s[i + 1] == '!' || s[i + 1] == '?')) {
            const char* e = (const char*)memchr(s + i, '>', len - i);
            i = e ? (size_t)(e - s) + 1 : len;
            continue;
        }
        const char* gt = (const char*)memchr(s + i, '>', len - i);
        if (!gt) break;  // unterminated tag: drop the tail
        size_t tag_end = (size_t)(gt - s);
        const char* p = s + i + 1;
        bool closing = (p < gt && *p == '/');
        if (closing) p++;
        const char* ns = p;
        while (p < gt && *p != ' ' && *p != '\t' && *p != '\n' &&
               *p != '\r' && *p != '/')
            p++;
        std::string tag(ns, p - ns);
        ascii_lower(tag);
        bool selfclose = tag_end > i && s[tag_end - 1] == '/';
        if (tag.empty()) { i = tag_end + 1; continue; }
        if (closing) {
            handle_endtag(P, tag);
        } else {
            std::vector<Attr> attrs;
            bool slash_in_val = false;
            parse_attrs(p, gt, attrs, &P.fallback, &slash_in_val);
            // <a href=foo/> is NOT self-closing: html.parser consumes
            // the '/' as the tail of the unquoted value — treating it
            // as a self-close would synthesize an endtag Python never
            // sees (and drop the anchor's text from the link harvest)
            if (slash_in_val) selfclose = false;
            handle_starttag(P, tag, attrs);
            if (selfclose) handle_endtag(P, tag);
            // raw-content elements: skip straight to the close tag
            // (html.parser CDATA mode for script/style)
            if (!selfclose && (tag == "script" || tag == "style")) {
                std::string close = "</" + tag;
                const char* e = nullptr;
                for (size_t k = tag_end + 1; k + close.size() <= len;
                     k++) {
                    if (s[k] == '<' &&
                        !strncasecmp(s + k, close.c_str(),
                                     close.size())) {
                        e = s + k;
                        break;
                    }
                }
                if (e) {
                    const char* ce =
                        (const char*)memchr(e, '>', len - (e - s));
                    handle_endtag(P, tag);
                    i = ce ? (size_t)(ce - s) + 1 : len;
                    continue;
                }
                i = len;  // unterminated script: drop the tail
                continue;
            }
        }
        i = tag_end + 1;
    }
}

// ---------------------------------------------------------------- ranks
// _density_ranks: per-sentence counts for body/heading/inlinktext,
// whole-hashgroup counts for the rest.
static void density_ranks(const std::vector<Tok>& toks,
                          std::vector<uint8_t>& out) {
    std::unordered_map<int32_t, int32_t> sent_counts;
    std::unordered_map<uint8_t, int32_t> hg_counts;
    for (auto& t : toks) {
        if (t.hg == HG_BODY || t.hg == HG_HEADING ||
            t.hg == HG_INLINKTEXT)
            sent_counts[t.sent]++;
        else
            hg_counts[t.hg]++;
    }
    out.resize(toks.size());
    for (size_t i = 0; i < toks.size(); i++) {
        const Tok& t = toks[i];
        int32_t c = (t.hg == HG_BODY || t.hg == HG_HEADING ||
                     t.hg == HG_INLINKTEXT)
                        ? sent_counts[t.sent]
                        : hg_counts[t.hg];
        int dr = MAXDENSITYRANK - (c - 1);
        out[i] = (uint8_t)(dr < 1 ? 1 : (dr > MAXDENSITYRANK
                                             ? MAXDENSITYRANK : dr));
    }
}

// _spam_ranks over tdoc.words — which INCLUDES the url tokens (they
// are appended to doc.words before docproc snapshots doc_words)
static void spam_ranks(const std::vector<Tok>& toks,
                       std::vector<uint8_t>& out) {
    size_t n_doc = toks.size();
    out.assign(toks.size(), MAXWORDSPAMRANK);
    if (n_doc < 40) return;
    std::unordered_map<std::string, int32_t> counts;
    for (size_t i = 0; i < n_doc; i++) counts[toks[i].word]++;
    for (size_t i = 0; i < n_doc; i++) {
        double frac = (double)counts[toks[i].word] / (double)n_doc;
        if (frac > 0.125) {
            int docked = (int)(MAXWORDSPAMRANK * (1.0 - frac) * 0.8);
            out[i] = (uint8_t)(docked < 2 ? 2 : docked);
        }
    }
}

template <class T>
static T* copy_vec(const std::vector<T>& v) {
    T* p = (T*)malloc(v.size() * sizeof(T) + 1);
    if (!v.empty()) memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
}

static char* copy_str(const std::string& s, int64_t* len) {
    char* p = (char*)malloc(s.size() + 1);
    memcpy(p, s.data(), s.size());
    p[s.size()] = 0;
    *len = (int64_t)s.size();
    return p;
}

}  // namespace

// ------------------------------------------------------------ public API
extern "C" {

osse_doc* osse_tokenize(const char* content, int64_t content_len,
                        const char* url, int64_t url_len, int is_html) {
    Parser P;
    if (is_html) {
        parse_html(P, content, (size_t)content_len);
    } else {
        if (!P.text.empty()) P.text += ' ';
        P.text.append(content, (size_t)content_len);
        P.emit_words(content, (size_t)content_len, HG_BODY);
    }
    size_t n_doc = P.toks.size();
    // url words: pos 0, INURL, sentence 0, no section
    if (url && url_len > 0) {
        std::string u(url, (size_t)url_len);
        P.scan_words(u.data(), u.size(), [&](const std::string& w) {
            P.toks.push_back({w, 0, HG_INURL, 0, 0});
        });
    }
    const std::vector<Tok>& toks = P.toks;
    size_t n = toks.size();

    std::vector<uint8_t> density, spam;
    density_ranks(toks, density);
    spam_ranks(toks, spam);

    // term ids + word buffer
    std::vector<uint64_t> termid(n);
    std::string words_buf;
    words_buf.reserve(n * 8);
    for (size_t i = 0; i < n; i++) {
        termid[i] = fnv_avalanche(toks[i].word.data(),
                                  toks[i].word.size(), 0) & TERMID_MASK;
        if (i) words_buf += '\n';
        words_buf += toks[i].word;
    }

    // bigrams: consecutive, same sentence + hashgroup, phrasable hg
    std::vector<uint64_t> b_termid;
    std::vector<int32_t> b_src;
    for (size_t i = 0; i + 1 < n; i++) {
        if (toks[i].sent != toks[i + 1].sent) continue;
        if (toks[i].hg != toks[i + 1].hg) continue;
        if (toks[i].hg == HG_INURL || toks[i].hg == HG_INMETATAG)
            continue;
        // bigram_id: hash64(w2, seed=hash64(w1)) & TERMID_MASK
        uint64_t h1 = fnv_avalanche(toks[i].word.data(),
                                    toks[i].word.size(), 0);
        b_termid.push_back(fnv_avalanche(toks[i + 1].word.data(),
                                         toks[i + 1].word.size(), h1) &
                           TERMID_MASK);
        b_src.push_back((int32_t)i);
    }

    // sections: per-path word content (order = first appearance)
    std::vector<uint64_t> sect_hash;
    std::vector<int32_t> sect_words;
    std::string sect_buf;
    {
        std::unordered_map<uint64_t, size_t> idx;
        std::vector<std::string> content_strs;
        for (size_t i = 0; i < n_doc; i++) {
            uint64_t sid = toks[i].sect;
            if (!sid) continue;
            auto it = idx.find(sid);
            size_t k;
            if (it == idx.end()) {
                k = content_strs.size();
                idx[sid] = k;
                sect_hash.push_back(sid);
                sect_words.push_back(0);
                content_strs.push_back(std::string());
            } else
                k = it->second;
            if (!content_strs[k].empty()) content_strs[k] += ' ';
            content_strs[k] += toks[i].word;
            sect_words[k]++;
        }
        for (size_t k = 0; k < content_strs.size(); k++) {
            if (k) sect_buf += '\x1e';
            sect_buf += content_strs[k];
        }
    }

    // links buffer
    std::string links_buf;
    for (size_t k = 0; k < P.links.size(); k++) {
        if (k) links_buf += '\x1e';
        links_buf += P.links[k].first;
        links_buf += '\x1f';
        links_buf += P.links[k].second;
    }

    // whitespace-normalize text (re.sub(r"\s+", " ", text).strip())
    std::string norm;
    norm.reserve(P.text.size());
    bool in_ws = true;
    {
        const char* tp = P.text.data();
        size_t tl = P.text.size(), ti2 = 0;
        while (ti2 < tl) {
            int adv;
            uint32_t cp = u8_decode(tp + ti2, tl - ti2, &adv);
            bool ws = cp == ' ' || cp == '\t' || cp == '\n' ||
                      cp == '\r' || cp == '\f' || cp == '\v' ||
                      cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
                      (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 ||
                      cp == 0x2029 || cp == 0x202F || cp == 0x205F ||
                      cp == 0x3000;
            if (ws) {
                if (!in_ws) norm += ' ';
                in_ws = true;
            } else {
                norm.append(tp + ti2, adv);
                in_ws = false;
            }
            ti2 += adv;
        }
    }
    while (!norm.empty() && norm.back() == ' ') norm.pop_back();

    osse_doc* d = (osse_doc*)calloc(1, sizeof(osse_doc));
    d->fallback = P.fallback ? 1 : 0;
    d->n = (int64_t)n;
    std::vector<int32_t> wp(n);
    std::vector<uint8_t> hg(n);
    std::vector<int32_t> sent(n);
    std::vector<uint64_t> sect(n);
    for (size_t i = 0; i < n; i++) {
        wp[i] = toks[i].pos;
        hg[i] = toks[i].hg;
        sent[i] = toks[i].sent;
        sect[i] = toks[i].sect;
    }
    d->termid = copy_vec(termid);
    d->wordpos = copy_vec(wp);
    d->hashgroup = copy_vec(hg);
    d->density = copy_vec(density);
    d->spam = copy_vec(spam);
    d->sentence = copy_vec(sent);
    d->sect = copy_vec(sect);
    d->nb = (int64_t)b_termid.size();
    d->b_termid = copy_vec(b_termid);
    d->b_src = copy_vec(b_src);
    d->words_buf = copy_str(words_buf, &d->words_len);
    d->text_buf = copy_str(norm, &d->text_len);
    d->title_buf = copy_str(P.title, &d->title_len);
    d->desc_buf = copy_str(P.desc, &d->desc_len);
    d->date_buf = copy_str(P.date, &d->date_len);
    d->links_buf = copy_str(links_buf, &d->links_len);
    d->nsect = (int64_t)sect_hash.size();
    d->sect_hash = copy_vec(sect_hash);
    d->sect_words = copy_vec(sect_words);
    d->sect_buf = copy_str(sect_buf, &d->sect_len);
    return d;
}

void osse_doc_free(osse_doc* d) {
    if (!d) return;
    free(d->termid); free(d->wordpos); free(d->hashgroup);
    free(d->density); free(d->spam); free(d->sentence); free(d->sect);
    free(d->b_termid); free(d->b_src);
    free(d->words_buf); free(d->text_buf); free(d->title_buf);
    free(d->desc_buf); free(d->date_buf); free(d->links_buf);
    free(d->sect_hash); free(d->sect_words); free(d->sect_buf);
    free(d);
}

// standalone hash entry points (parity tests against utils/ghash.py)
uint64_t osse_hash64(const char* data, int64_t len, uint64_t seed) {
    return fnv_avalanche(data, (size_t)len, seed);
}

}  // extern "C"
