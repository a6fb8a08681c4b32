/* Native sequence I/O: streaming FASTA/FASTQ(.gz) reader with inline
 * 2-bit+case query encoding, and a fast rank-line formatter.
 *
 * Host-side equivalent of the reference's SeqIO submodule reader
 * (seq_io::Reader::get_next_read_to_buffer, used at
 * src/CLI/sbwt_search.cpp:46-65) and of the manual itoa output writer
 * (print_vector, src/CLI/sbwt_search.cpp:21-43).  The device query path
 * consumes int8 code arrays; this reader produces them directly from the
 * byte stream so the Python layer never touches per-base data.
 *
 * Exposed via ctypes (see native/__init__.py); gzread transparently
 * handles both gzipped and plain files.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

/* query encoding: ACGT -> 0..3, acgt -> 4..7, everything else -> -1
 * (matches utils/dna.py encode_query / globals.hh:38-53 semantics) */
static signed char CODE[256];
static int code_init_done = 0;
static void code_init(void) {
    if (code_init_done) return;
    memset(CODE, -1, sizeof(CODE));
    CODE['A'] = 0; CODE['C'] = 1; CODE['G'] = 2; CODE['T'] = 3;
    CODE['a'] = 4; CODE['c'] = 5; CODE['g'] = 6; CODE['t'] = 7;
    code_init_done = 1;
}

#define RDBUF (1 << 20)

typedef struct {
    gzFile gz;
    unsigned char *buf;
    int64_t len, pos;
    int eof;
    int format; /* 0 unknown, 1 fasta, 2 fastq */
    int in_seq; /* fasta: currently inside a sequence */
} Reader;

static int fill(Reader *r) {
    if (r->eof) return 0;
    int n = gzread(r->gz, r->buf, RDBUF);
    if (n <= 0) { r->eof = 1; return 0; }
    r->len = n; r->pos = 0;
    return 1;
}

static int peek(Reader *r) {
    if (r->pos >= r->len && !fill(r)) return -1;
    return r->buf[r->pos];
}

static int nextc(Reader *r) {
    if (r->pos >= r->len && !fill(r)) return -1;
    return r->buf[r->pos++];
}

/* skip to just after the next newline */
static void skip_line(Reader *r) {
    for (;;) {
        if (r->pos >= r->len && !fill(r)) return;
        unsigned char *nl = memchr(r->buf + r->pos, '\n', r->len - r->pos);
        if (nl) { r->pos = nl - r->buf + 1; return; }
        r->pos = r->len;
    }
}

void *sq_open(const char *path) {
    code_init();
    gzFile gz = gzopen(path, "rb");
    if (!gz) return NULL;
    gzbuffer(gz, 1 << 20);
    Reader *r = calloc(1, sizeof(Reader));
    r->gz = gz;
    r->buf = malloc(RDBUF);
    int c = peek(r);
    r->format = (c == '@') ? 2 : (c == '>') ? 1 : 0;
    if (!r->format) { gzclose(gz); free(r->buf); free(r); return NULL; }
    return r;
}

void sq_close(void *h) {
    Reader *r = h;
    if (!r) return;
    gzclose(r->gz);
    free(r->buf);
    free(r);
}

/* Append encoded sequence bytes until terminator logic per format.
 * Returns length appended, or -1 if capacity exhausted. */
static int64_t read_seq_fasta(Reader *r, signed char *codes, int64_t cap) {
    int64_t len = 0;
    for (;;) {
        int c = peek(r);
        if (c < 0) return len;
        if (c == '>') return len;
        if (c == '\n' || c == '\r') { r->pos++; continue; }
        /* bulk-encode the rest of this buffered line */
        int64_t avail = r->len - r->pos;
        unsigned char *nl = memchr(r->buf + r->pos, '\n', avail);
        int64_t line = nl ? (int64_t)(nl - r->buf - r->pos) : avail;
        if (len + line > cap) return -1;
        for (int64_t i = 0; i < line; i++) {
            unsigned char ch = r->buf[r->pos + i];
            if (ch != '\r') codes[len++] = CODE[ch];
        }
        r->pos += line;
    }
}

static int64_t read_seq_fastq(Reader *r, signed char *codes, int64_t cap) {
    int64_t len = 0;
    for (;;) {
        if (r->pos >= r->len && !fill(r)) break;
        unsigned char *nl = memchr(r->buf + r->pos, '\n', r->len - r->pos);
        int64_t line = nl ? (int64_t)(nl - r->buf - r->pos) : r->len - r->pos;
        if (len + line > cap) return -1;
        for (int64_t i = 0; i < line; i++) {
            unsigned char ch = r->buf[r->pos + i];
            if (ch != '\r') codes[len++] = CODE[ch];
        }
        r->pos += line;
        if (nl) { r->pos++; break; }
    }
    skip_line(r); /* '+' line */
    skip_line(r); /* quality line */
    return len;
}

/* Read up to max_reads records, encoding into codes (capacity codes_cap).
 * offsets[i] = start of read i in codes; offsets[n_read] = total length.
 * Returns number of reads (0 = EOF, -1 = error / capacity too small for a
 * single read). Stops early when the next read may not fit. */
int64_t sq_read_batch(void *h, signed char *codes, int64_t codes_cap,
                      int64_t *offsets, int64_t max_reads) {
    Reader *r = h;
    int64_t n = 0, used = 0;
    while (n < max_reads) {
        int c = peek(r);
        if (c < 0) break;
        if (r->format == 1) {
            if (c != '>') return -1;
            skip_line(r); /* header */
            int64_t len = read_seq_fasta(r, codes + used, codes_cap - used);
            if (len < 0) return n ? n : -1;
            offsets[n++] = used;
            used += len;
        } else {
            if (c != '@') return -1;
            skip_line(r); /* header */
            int64_t len = read_seq_fastq(r, codes + used, codes_cap - used);
            if (len < 0) return n ? n : -1;
            offsets[n++] = used;
            used += len;
        }
        if (codes_cap - used < (codes_cap >> 4)) break; /* refill headroom */
    }
    offsets[n] = used;
    return n;
}

/* ---------------------------------------------------------------------
 * Output formatting: ranks space-separated with trailing space + '\n'
 * (byte-identical to print_vector, src/CLI/sbwt_search.cpp:21-43).
 * vals: int64 answers (-1 allowed); lens[i] = number of answers of read i.
 * Returns bytes written, or -1 if out_cap too small.
 * ------------------------------------------------------------------- */
int64_t sq_format_ranks(const int64_t *vals, const int64_t *lens,
                        int64_t n_reads, char *out, int64_t out_cap) {
    char tmp[24];
    int64_t w = 0, v = 0;
    for (int64_t i = 0; i < n_reads; i++) {
        for (int64_t j = 0; j < lens[i]; j++) {
            int64_t x = vals[v++];
            if (w + 24 > out_cap) return -1;
            if (x < 0) { out[w++] = '-'; out[w++] = '1'; }
            else if (x == 0) { out[w++] = '0'; }
            else {
                int t = 0;
                while (x > 0) { tmp[t++] = '0' + (x % 10); x /= 10; }
                while (t > 0) out[w++] = tmp[--t];
            }
            out[w++] = ' ';
        }
        if (w + 1 > out_cap) return -1;
        out[w++] = '\n';
    }
    return w;
}
